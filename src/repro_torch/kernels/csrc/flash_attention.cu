// Flash-attention forward for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel `_flash_kernel` behind
// `flash_attention` in src/repro/kernels/flash_attention.py: attention
// with an fp32 online softmax (running max m, sum l, accumulator acc),
// causal / sliding-window / q_offset masks, and an output of
// acc / max(l, 1e-30) in q's dtype.  Unlike the TPU kernel it takes a
// `scale`, indexes (B, S, H, hd) through the caller's strides (no
// moveaxis copies), and masks ragged Sq / Skv tails itself.
//
// Bound at the serving path's shape (B=4, S=2048, H=32, hd=64, causal,
// bf16) on an H100 SXM: the visible half of QK^T and PV is
// 2*B*H*hd*S*(S+1) ~ 68.8 GFLOP, ~70 us at 989 TFLOP/s; q, k, v and o are
// ~134 MB, ~40 us at 3.35 TB/s.  So the call is bound by tensor-core
// operations at ~70 us (~1.5 ms per 22-layer prefill).  At hd 128 (Qwen3-14B
// heads, H=40) the bound is ~174 us of operations; at Gemma-7B's prefill
// (B=4, S=2048, H=16, hd=256) ~139 us (137.5 GFLOP), ~3.9 ms per 28-layer
// prefill.  Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py):
// at (2, 2048, 16, 256) causal this kernel takes 0.1986 ms (346 TFLOP/s)
// against 0.1484 ms for SDPA and a bound of 0.0695 ms; the SIMT path it
// replaced there took 6.52 ms.  At Gemma-7B's prefill (4, 2048, 16, 256)
// it takes 0.3472 ms (396 TFLOP/s) against 0.2566 ms for SDPA and a bound
// of 0.1390 ms.  The softmax's 2^x runs
// on the SFUs, 16 per clock per SM: a 128 x 128 tile needs ~0.56 us of
// them, about as long as its two products need on the tensor cores.
//
// bf16 design at hd 64, 128 and 256 (the serving and training paths):
//  * One block per (b*h, 128-row q tile), one block per SM: two consumer
//    warpgroups own 64 q rows each.  At hd 64 and 128 a producer
//    warpgroup, of which one thread works, issues the loads.  ptxas sizes
//    registers by warpgroup (168 a thread for three), so setmaxnreg gives
//    the consumers 224 and the producer 56.
//  * The producer loads the Q tile once and K and V tiles into a ring of 3
//    (hd 64) or 2 (hd 128, 256) stages of dynamic shared memory with TMA
//    (cp.async.bulk.tensor, 128-byte swizzle; 113 / 97 / 193 KB).  Each
//    tensor has one 4-D map over (hd, S, H, B) built on the host from the
//    caller's strides, so strided views load uncopied; a swizzled box row
//    is 64 bf16, so a tile of hd 128 / 256 takes 2 / 4 boxes.  Per stage a
//    K-full and a V-full mbarrier (TMA transaction bytes) hand tiles to the
//    consumers, and a K-empty and a V-empty mbarrier (one arrival per
//    consumer warp) hand them back as soon as the product that reads them
//    is done.
//  * S = Q K^T is wgmma.mma_async with Q and K read K-major from shared
//    memory.  The fp32 online softmax runs in base 2 on the accumulator
//    fragment (a row on the 4 lanes of a quad, max and sum over four
//    partial chains).  P is rounded to bf16 in place into the A fragments of
//    O += P V, wgmma m64n64k16 with P from registers and V read MN-major
//    from shared memory: no transpose.
//  * Tiles: at hd 64, 128 keys make S one m64n128k16 per 16-wide k step and
//    halve the softmax's per-tile bookkeeping against 64.  At hd 128 the
//    consumer would need more than 224 registers for S (64), O (64) and P
//    (32) and spills, so it takes 64 keys.  128 q rows let one K/V tile feed
//    two warpgroups.
//  * hd 256 (Gemma-7B): a consumer's O alone is 128 fp32 registers, S (64
//    keys) 32 and P 16, more than the 168 that ptxas budgets a 384-thread
//    kernel's wgmma pipeline whatever setmaxnreg gives (the backward's
//    finding), so this head dim runs 256 threads and no producer
//    warpgroup (255 registers a thread): thread 0 loads Q and the first two
//    stages, and the last of the 8 consumer warps to release a K or V stage
//    (release_last, a counter in shared memory where the empty mbarrier
//    would be) loads the tile two ahead into it.  64-key tiles, 2 stages:
//    Q 64 KB + 2 x (32 + 32) KB.  S is 16 k steps of m64n64k16, P V 4 k
//    steps of 4 m64n64k16 (one per 64 columns of O).
//  * Masks only on tiles that hold a masked pair (the causal diagonal, the
//    window edge, the Skv tail): there each row's visible keys are a range
//    [lo, hi) and the others get -inf.  TMA fills rows past Skv and Sq with
//    zeros; rows past Sq are not stored.
//  * Schedule: kv_range skips the KV tiles masked for the whole q tile
//    (past the causal diagonal, before the window).  The grid is 1-D with
//    the q tiles of one head adjacent, heaviest first, so the blocks that
//    share a head's K and V run together and read them from L2.
// SIMT design, for fp32 at every head dim (the tensor cores would round to
// tf32) and for bf16 at head dims 16 and 32 (the reduced configs): TPR
// threads per q row (4, or 8 at hd 256, so a thread holds at most 32
// floats each of q and acc in registers), over K/V tiles of 32 keys (16 at
// hd 256: two fp32 tiles stay within the 48 KB of static shared memory)
// that a warp reads by broadcast; the same kv_range, heaviest q tiles
// first.  bf16 is loaded, converted to fp32 on the way into registers and
// shared memory, and rounded once at the store.  Masked logits are -1e30
// there, as in the plain version.  This path is simple and right, not
// fast: it does the products on the fp32 FMA units (67 TFLOP/s peak).
// Either kernel gives the plain version's result for a row that sees at
// least one key.
//
// DeepSeek-V3's latent (MLA) layout (entry `flash_attention_mla_fwd`): q
// (B, Sq, H, 576), one k head (B, Skv, 1, 576) and one v head (B, Skv, 1,
// 512) shared by all of q's heads (the absorbed form of
// src/repro/models/blocks.py:180-200, which the JAX package sends to its
// chunked reference because the Pallas kernel cannot take it).  Bound at
// the served shape (4, 2048, 128, 576 / 512), causal, bf16: 2,098,176
// causal pairs x 512 (b, h) x 2 x (576 + 512) = 2.34 TFLOP, 2.363 ms at 989
// TFLOP/s; its bytes (q, k, v, o ~2.3 GB) take 0.68 ms at 3.35 TB/s.  Both
// kernels take heads as rows, as FlashMLA lays them out, since every head
// reads the same K and V: a block holds 64 rows (q position, head) of one
// sequence, so at H = 128 a block is 64 heads of one position, and walks
// the key tiles of the causal `kv_range` of its positions, heaviest row
// tiles first.
//
// bf16 (`flash_fwd_mla_bf16`): two consumer warpgroups, 256 threads, no
// producer (as at hd 256).
//  * Q (64 rows x 576, 9 swizzled 64-column boxes, 72 KB) is loaded once by
//    TMA through a map over (576, Sq H, B): q's rows (position, head) at one
//    stride, which the wrapper checks.  K tiles of 64 keys (72 KB) stream
//    through a ring of 2 stages.  When v is a view of k's first 512 features
//    (as `mla_attention` passes it), V is the K tile's first 8 boxes and is
//    not loaded again (`kSharedKV`); a separate v takes one K stage and one
//    V stage (64 KB) instead.  Q + 2 K stages + the exchange are 226 KB of
//    the 227.  Thread 0 loads Q and the first tiles; the last of the 8
//    warps to release a stage (`release_last`) refills it.
//  * O (64 x 512 fp32) is split by columns: warpgroup w owns [256 w, 256 w
//    + 256), 128 registers a thread.  S is split by keys: warpgroup w
//    computes S for keys [32 w, 32 w + 32) of the tile over all 576
//    features (36 k steps of m64n32k16, Q and K K-major in shared memory),
//    so both products are halved evenly.  The row max crosses between the
//    warpgroups through shared memory (each keeps its own partial sum l,
//    added at the end); each splits its half of P into bf16 A fragments of
//    its high part and of the rest (P to ~2^-17, as the fp32 plain twin
//    has it: with P in bf16 alone, DeepSeek-V3's routing turned the
//    rounding into other experts, and chip_smoke.py's 5-layer serve on an
//    H100 put the logits 3.3e-2 from the twin's, past its 2e-2 bar; the
//    split costs ~1.1 of ~7.2 ms at (4, 2048, 128), tools/mla_ablation.py)
//    and hands them to the other in the fragment layout (both own the same 64
//    rows, so a thread reads its twin's registers), and each runs O += P V
//    over all 64 keys for its 256 columns: 2 x 4 k steps of m64n256k16, P
//    from registers, V read MN-major from the K tile.
//  * Per tile the block issues P V of the last tile and S of this one
//    together, waits for the first (its stage is then free and refilled
//    with the tile two ahead, under this tile's work) and then the second:
//    every product is waited for on the path that issued it.  The softmax
//    runs in base 2 on the accumulators, masked only on tiles that hold a
//    masked pair: at H = 128 every row of a block has the same causal
//    limit; for H < 64 or H not a multiple of 64 a tile spans positions
//    and each row gets its own [lo, hi).  Rows past Sq H read TMA's zeros
//    and are not stored; keys past Skv are zeros and masked; the causal
//    `kv_range` never reads a tile past the block's last visible key (the
//    unwritten end of a longer cache).
// fp32 (`flash_fwd_mla`, SIMT; the tensor cores would round to tf32): the
// products on the fp32 FMA units (67 TFLOP/s).  A block's q (scaled, fp32)
// is resident in shared memory, and it walks key tiles of 32: the K tile,
// then the V tile in the same buffer (580-float rows: 222,720 bytes of
// dynamic shared memory, one block an SM).  256 threads; a thread owns 4
// rows and keys tx, tx + 16 of S (so its 4 rows' q and 2 keys' k feed 8
// products a float4 of the 576 features), and the same 4 rows x 32 columns
// of O (128 fp32 accumulators), P passed between the 16 lanes of a row by
// shuffles.  The online softmax is the SIMT kernel's, per row, over the 16
// lanes.
//
// The TMA, mbarrier, descriptor and wgmma primitives and the host-side
// tensor maps live in hopper.cuh, shared with the backward's wgmma kernels.
//
// lse (optional, for the backward): a null pointer writes nothing, so
// serving pays nothing.  Otherwise each row writes, in fp32 at
// lse[(b * H + h) * Sq + row], the natural log of its softmax denominator
// over the *scaled* logits, lse = m + log(max(l, 1e-30)), as
// src/repro/kernels/ref.py:118 computes it.  The wgmma path keeps m in base
// 2 (its softmax runs on exp2 with log2(e) folded into the scale), so it
// writes m * ln(2) + log(l).

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
using flash::kNegInf;
using flash::Strides;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, Sq) fp32, or null
  Strides sq, sk, sv, so;
  int H, Sq, Skv;
  int causal, window, q_offset;  // window <= 0: none
  float scale;
};

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  return flash::visible(p.Skv, p.causal, p.window, qpos, kpos);
}

// KV tiles [lo, hi) that hold a visible key for some row of q tile [q0, q0+bq).
__device__ __forceinline__ void kv_range(const Params& p, int q0, int bq,
                                         int bk, int& lo, int& hi) {
  flash::kv_range(p.Sq, p.Skv, p.causal, p.window, p.q_offset, q0, bq, bk,
                  lo, hi);
}

// ---------------------------------------------------------------------------
// bf16 at hd 64, 128 and 256: TMA + mbarrier ring + wgmma kernel
// ---------------------------------------------------------------------------

constexpr int kBQ = 128;        // q rows per block, 64 per consumer warpgroup
constexpr int kConsumers = 2;   // consumer warpgroups

// Tile sizes and the shared-memory layout of a block, in bytes from a
// 1024-byte-aligned base (the 128-byte swizzle repeats every 1024 bytes):
// Q, the K stages, the V stages, then the mbarriers (8 bytes each).  At hd
// 64 and 128 a producer warpgroup loads the tiles (384 threads); at hd 256
// there is none (256 threads), and the "empty" slots are release counters
// (release_last) instead of mbarriers.
template <int HD>
struct Cfg {
  static constexpr bool kProducer = HD != 256;
  static constexpr int kThreads = 128 * (kConsumers + (kProducer ? 1 : 0));
  static constexpr int kBK = HD == 64 ? 128 : 64;  // keys per K/V tile
  static constexpr int kStages = HD == 64 ? 3 : 2;
  static constexpr int kSub = HD / kBox;           // 64-wide column blocks
  static constexpr int kQBytes = kBQ * HD * 2;
  static constexpr int kTileBytes = kBK * HD * 2;  // one K or one V tile
  static constexpr uint32_t kK = kQBytes;          // stage st: + st * kTileBytes
  static constexpr uint32_t kV = kK + kStages * kTileBytes;
  static constexpr uint32_t kQFull = kV + kStages * kTileBytes;
  static constexpr uint32_t kKFull = kQFull + 8;   // stage st: + 8 st, as the rest
  static constexpr uint32_t kVFull = kKFull + 8 * kStages;
  static constexpr uint32_t kKEmpty = kVFull + 8 * kStages;
  static constexpr uint32_t kVEmpty = kKEmpty + 8 * kStages;
  static constexpr int kSmem = 1024 + kVEmpty + 8 * kStages;  // + alignment
};

// S = Q K^T for one warpgroup (64 x kBK), both operands K-major; issued,
// not waited for.
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[Cfg<HD>::kBK / 2],
                                         uint32_t q_rows, uint32_t k_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss(s,
             sw128_desc(q_rows + (kk / 4) * kBQ * 128 + (kk % 4) * 32, 16, 1024),
             sw128_desc(k_tile + (kk / 4) * Cfg<HD>::kBK * 128 + (kk % 4) * 32,
                        16, 1024),
             kk > 0);
  wgmma_commit();
}

// O += P V: V is [key][hd], read MN-major; a k step is 16 keys (2048
// bytes).  Issued, not waited for.
template <int HD>
__device__ __forceinline__ void issue_pv(
    float (&o)[HD / 64][32], const uint32_t (&pa)[Cfg<HD>::kBK / 16][4],
    uint32_t v_tile) {
  constexpr int kBK = Cfg<HD>::kBK;
#pragma unroll
  for (int c = 0; c < HD / 64; ++c) reg_fence(o[c]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int c = 0; c < HD / 64; ++c)
      wgmma_rs(o[c], pa[kk],
               sw128_desc(v_tile + c * kBK * 128 + kk * 2048, kBK * 128, 1024));
  wgmma_commit();
}

// One K or V tile (keys from k0) into the ring slot `dst`, announced on
// the stage's full mbarrier `full`; by one thread.
template <int HD>
__device__ __forceinline__ void load_tile(const CUtensorMap* map,
                                          uint32_t dst, uint32_t full,
                                          int k0, int h, int b) {
  mbar_expect_tx(full, Cfg<HD>::kTileBytes);
  for (int c = 0; c < Cfg<HD>::kSub; ++c)
    tma_load(dst + c * Cfg<HD>::kBK * 128, map, full, c * kBox, k0, h, b);
}

// The producer: one thread loads Q, then K and V tile by tile into the ring,
// each stage once the consumers have released its previous tile.  Without
// a producer warpgroup, thread 0 runs it for the first kStages tiles (no
// waits) and the consumers refill the ring.
template <int HD>
__device__ __forceinline__ void produce(const CUtensorMap& tq,
                                        const CUtensorMap& tk,
                                        const CUtensorMap& tv, uint32_t base,
                                        int q0, int h, int b, int lo,
                                        int n_tiles) {
  using C = Cfg<HD>;
  mbar_expect_tx(base + C::kQFull, C::kQBytes);
  for (int c = 0; c < C::kSub; ++c)
    tma_load(base + c * kBQ * 128, &tq, base + C::kQFull, c * kBox, q0, h, b);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % C::kStages, k0 = (lo + it) * C::kBK;
    const uint32_t parity = (it / C::kStages - 1) & 1;
    if (it >= C::kStages) mbar_wait(base + C::kKEmpty + 8 * st, parity);
    load_tile<HD>(&tk, base + C::kK + st * C::kTileBytes,
                  base + C::kKFull + 8 * st, k0, h, b);
    if (it >= C::kStages) mbar_wait(base + C::kVEmpty + 8 * st, parity);
    load_tile<HD>(&tv, base + C::kV + st * C::kTileBytes,
                  base + C::kVFull + 8 * st, k0, h, b);
  }
}

// The online softmax of one S tile (N fp32 per thread), in place: S -> P =
// exp2(S * scale_log2 - m), the running max m and sum l of this thread's
// two rows updated, and corr the factor that rescales O to the new max.
// When `masked`, the keys outside row r's visible range [lo[r], hi[r])
// (relative to this thread's first column) get -inf, so p = 0; m starts
// at -1e30, so a row that has seen no key yet keeps finite m and l = 0.
// Max and sum run over four partial chains per row.
template <int N>
__device__ __forceinline__ void softmax_tile(float (&s)[N], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             bool masked, const int (&lo)[2],
                                             const int (&hi)[2],
                                             float scale_log2) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + (e & 1), r = e >> 1;
        s[4 * j + e] = col >= lo[r] && col < hi[r] ? s[4 * j + e] * scale_log2
                                                   : -INFINITY;
      }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] *= scale_log2;
  }
  float part[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      part[r][k] = fmaxf(s[4 * k + 2 * r], s[4 * k + 2 * r + 1]);
#pragma unroll
  for (int j = 4; j < N / 4; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      part[r][j % 4] = fmaxf(part[r][j % 4],
                             fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // a row lives on the 4 lanes of a quad
    float mx = fmaxf(fmaxf(part[r][0], part[r][1]),
                     fmaxf(part[r][2], part[r][3]));
    mx = fmaxf(m[r], mx);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    corr[r] = exp2_approx(m[r] - mx);
    m[r] = mx;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) s[i] = exp2_approx(s[i] - m[(i >> 1) & 1]);
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) part[r][k] = s[4 * k + 2 * r] + s[4 * k + 2 * r + 1];
#pragma unroll
  for (int j = 4; j < N / 4; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      part[r][j % 4] += s[4 * j + 2 * r] + s[4 * j + 2 * r + 1];
#pragma unroll
  for (int r = 0; r < 2; ++r)  // per-lane partial sum; quad-reduced at the end
    l[r] = l[r] * corr[r] + ((part[r][0] + part[r][1]) + (part[r][2] + part[r][3]));
}

// Consumer warpgroup WG owns q rows [q0 + 64 WG, q0 + 64 WG + 64).
// Iteration it issues S_it = Q K_it^T and O += P_{it-1} V_{it-1} together,
// waits for S_it, runs its softmax, waits for P V and rescales O to the new
// row max.  (ptxas schedules the wait for P V ahead of the softmax's
// exponentials, so within a warpgroup the two do not overlap; the overlap
// comes from the two warpgroups taking turns at issuing, through named
// barriers: one's softmax runs under the other's products.)  The first
// tile's S and the last tile's P V stand outside the loop, so that every
// product is waited for on the path that issued it: a product waited for
// on another path makes ptxas serialize them all.  WG is a template
// argument and every shared-memory address derives from the block's base,
// so the wgmma descriptors are warp-uniform; where ptxas cannot prove
// that, it serializes the wgmma instructions too.
template <int HD, int WG>
__device__ __forceinline__ void consume(const Params& p,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, uint32_t base,
                                        int q0, int h, int b, int lo,
                                        int n_tiles) {
  using C = Cfg<HD>;
  constexpr int kBK = C::kBK, kS = kBK / 2;
  const int lane = threadIdx.x % 32, t = lane % 4;
  // The warp is done with tile it's K (V when `v`): one arrival on the
  // stage's empty mbarrier for the producer, or, without one, the last of
  // the 4 x kConsumers consumer warps to release the stage loads tile
  // it + kStages into it.
  auto release = [&](bool v, int it) {
    const int st = it % C::kStages;
    const uint32_t slot = base + (v ? C::kVEmpty : C::kKEmpty) + 8 * st;
    __syncwarp();
    if constexpr (C::kProducer) {
      if (lane == 0) mbar_arrive(slot);
    } else if (release_last<4 * kConsumers>(slot) &&
               it + C::kStages < n_tiles && lane == 0) {
      load_tile<HD>(v ? tv : tk,
                    base + (v ? C::kV : C::kK) + st * C::kTileBytes,
                    base + (v ? C::kVFull : C::kKFull) + 8 * st,
                    (lo + it + C::kStages) * kBK, h, b);
    }
  };
  const int row0 = q0 + 64 * WG + 16 * (threadIdx.x % 128 / 32) + lane / 4;
  const float scale_log2 = p.scale * kLog2e;  // softmax in base 2
  const uint32_t q_rows = base + WG * 64 * 128;  // this warpgroup's Q rows
  // keys visible to this thread's rows row0 and row0 + 8: [klo, khi)
  int klo[2], khi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + 8 * r + p.q_offset;
    khi[r] = p.causal ? min(qpos + 1, p.Skv) : p.Skv;
    klo[r] = p.window > 0 ? qpos - p.window + 1 : 0;
  }
  const int wq_first = q0 + 64 * WG + p.q_offset;  // the warpgroup's q positions
  const int wq_last = wq_first + 63;
  // softmax of kv tile k0 in s: masked only where a pair of the warpgroup is
  auto softmax = [&](float (&s)[kS], float (&m)[2], float (&l)[2],
                     float (&corr)[2], int k0) {
    const bool masked = k0 + kBK > p.Skv ||
                        (p.causal && k0 + kBK - 1 > wq_first) ||
                        (p.window > 0 && wq_last - k0 >= p.window);
    const int lo_rel[2] = {klo[0] - k0 - 2 * t, klo[1] - k0 - 2 * t};
    const int hi_rel[2] = {khi[0] - k0 - 2 * t, khi[1] - k0 - 2 * t};
    softmax_tile(s, m, l, corr, masked, lo_rel, hi_rel, scale_log2);
  };

  float o[C::kSub][32];
#pragma unroll
  for (int c = 0; c < C::kSub; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];

  uint32_t pa[kBK / 16][4];  // P of the previous tile

  mbar_wait(base + C::kQFull, 0);
  if (n_tiles > 0) {
    if (WG == 1) bar_arrive(1);  // warpgroup 0 issues first
    {  // tile 0: S only
      float s[kS];
      mbar_wait(base + C::kKFull, 0);
      bar_sync(1 + WG);
      issue_qk<HD>(s, q_rows, base + C::kK);
      if (WG == 0 || n_tiles > 1) bar_arrive(2 - WG);
      wgmma_wait<0>();
      reg_fence(s);
      release(false, 0);
      softmax(s, m, l, corr, lo * kBK);
      pack_p(s, pa);
    }
    for (int it = 1; it < n_tiles; ++it) {
      const int st = it % C::kStages;
      const int pst = (it - 1) % C::kStages;  // tile it - 1
      float s[kS];
      mbar_wait(base + C::kKFull + 8 * st, (it / C::kStages) & 1);
      mbar_wait(base + C::kVFull + 8 * pst, ((it - 1) / C::kStages) & 1);
      bar_sync(1 + WG);
      issue_qk<HD>(s, q_rows, base + C::kK + st * C::kTileBytes);
      issue_pv<HD>(o, pa, base + C::kV + pst * C::kTileBytes);
      if (WG == 0 || it + 1 < n_tiles) bar_arrive(2 - WG);  // the other's turn
      wgmma_wait<1>();  // S_it
      reg_fence(s);
      release(false, it);
      softmax(s, m, l, corr, (lo + it) * kBK);
      wgmma_wait<0>();  // P_{it-1} V_{it-1}: V and pa are free
#pragma unroll
      for (int c = 0; c < C::kSub; ++c) {
        reg_fence(o[c]);
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= corr[(i >> 1) & 1];
      }
      release(true, it - 1);
      pack_p(s, pa);
    }
    const int pst = (n_tiles - 1) % C::kStages;  // the last tile's P V
    mbar_wait(base + C::kVFull + 8 * pst, ((n_tiles - 1) / C::kStages) & 1);
    issue_pv<HD>(o, pa, base + C::kV + pst * C::kTileBytes);
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < C::kSub; ++c) reg_fence(o[c]);
  }

  auto* O = static_cast<__nv_bfloat16*>(p.o) + b * p.so.b + h * p.so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row0 + 8 * r;
    if (row >= p.Sq) continue;
    if (p.lse != nullptr && t == 0)  // m is in base 2
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + row] =
          m[r] * kLn2 + logf(fmaxf(l[r], 1e-30f));
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = O + row * p.so.s + 2 * t;
#pragma unroll
    for (int c = 0; c < C::kSub; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 64 * c + 8 * j) =
            pack_bf16(o[c][4 * j + 2 * r] * inv, o[c][4 * j + 2 * r + 1] * inv);
  }
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::kThreads, 1)
    flash_fwd_bf16(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Params p) {
  using C = Cfg<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;

  const int n_qt = (p.Sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (n_qt - 1 - blockIdx.x % n_qt) * kBQ;  // heaviest first
  const int b = bh / p.H, h = bh % p.H;
  int lo, hi;
  kv_range(p, q0, kBQ, C::kBK, lo, hi);
  const int n_tiles = max(hi - lo, 0);  // tile it is kv tile lo + it

  if (threadIdx.x == 0) {
    mbar_init(base + C::kQFull, 1);
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(base + C::kKFull + 8 * st, 1);
      mbar_init(base + C::kVFull + 8 * st, 1);
      if constexpr (C::kProducer) {  // one arrival per consumer warp
        mbar_init(base + C::kKEmpty + 8 * st, 4 * kConsumers);
        mbar_init(base + C::kVEmpty + 8 * st, 4 * kConsumers);
      } else {  // release counters
        uint8_t* smem = smem_raw + (base - smem_addr(smem_raw));
        *reinterpret_cast<uint32_t*>(smem + C::kKEmpty + 8 * st) = 0;
        *reinterpret_cast<uint32_t*>(smem + C::kVEmpty + 8 * st) = 0;
      }
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // The role comes from a warp-uniform warp index (threadIdx alone would
  // make the branches divergent in ptxas's eyes).
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  auto consumers = [&] {
    if (warp < 4)
      consume<HD, 0>(p, &tk, &tv, base, q0, h, b, lo, n_tiles);
    else
      consume<HD, 1>(p, &tk, &tv, base, q0, h, b, lo, n_tiles);
  };
  if constexpr (C::kProducer) {
    // setmaxnreg moves registers from the producer warpgroup to the
    // consumers: (168 - 56) x 128 = (224 - 168) x 256.
    if (warp >= 4 * kConsumers) {
      setmaxnreg_dec<56>();
      if (warp == 4 * kConsumers && threadIdx.x % 32 == 0)
        produce<HD>(tq, tk, tv, base, q0, h, b, lo, n_tiles);
    } else {
      setmaxnreg_inc<224>();
      consumers();
    }
  } else {
    if (threadIdx.x == 0)  // Q and the first stages; the consumers refill
      produce<HD>(tq, tk, tv, base, q0, h, b, lo, min(n_tiles, C::kStages));
    consumers();
  }
}

// ---------------------------------------------------------------------------
// SIMT kernel: fp32 at every head dim, bf16 at 16 and 32
// ---------------------------------------------------------------------------

constexpr int kFThreads = 256;
constexpr int kFChunk = 8;      // keys per online-softmax update

// TPR threads per q row; a thread holds the float4 chunks {TPR i + t} of its
// row's q and acc (at most 32 floats each).  BK keys per K/V tile: two fp32
// tiles in static shared memory, at most 32 KB.
template <int HD>
struct Simt {
  static constexpr int kTPR = HD == 256 ? 8 : 4;
  static constexpr int kBQ = kFThreads / kTPR;  // q rows per block
  static constexpr int kBK = HD == 256 ? 16 : 32;
  static constexpr int kC4 = HD / (4 * kTPR);   // float4 chunks a thread
};

template <int HD, typename T>
__global__ void __launch_bounds__(kFThreads)
    flash_fwd_simt(const Params p) {
  using S = Simt<HD>;
  constexpr int TPR = S::kTPR, C4 = S::kC4, BK = S::kBK;
  __shared__ __align__(16) float sK[BK * HD];
  __shared__ __align__(16) float sV[BK * HD];

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * S::kBQ;  // heaviest first
  const int t = threadIdx.x % TPR;
  const int qi = q0 + threadIdx.x / TPR;
  const int qpos = qi + p.q_offset;

  const T* Q = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* K = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* V = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;
  T* O = static_cast<T*>(p.o) + b * p.so.b + h * p.so.h;

  float q[4 * C4], acc[4 * C4];
#pragma unroll
  for (int i = 0; i < C4; ++i) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qi < p.Sq) x = flash::load4(Q + qi * p.sq.s + 4 * (TPR * i + t));
    q[4 * i + 0] = x.x * p.scale;  // (q * scale) . k, as the plain version
    q[4 * i + 1] = x.y * p.scale;
    q[4 * i + 2] = x.z * p.scale;
    q[4 * i + 3] = x.w * p.scale;
  }
#pragma unroll
  for (int d = 0; d < 4 * C4; ++d) acc[d] = 0.f;
  float m = kNegInf, l = 0.f;

  int lo, hi;
  kv_range(p, q0, S::kBQ, BK, lo, hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK;
    for (int c = threadIdx.x; c < BK * HD / 4; c += kFThreads) {
      const int r = c / (HD / 4), cc = c % (HD / 4);
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < p.Skv) {
        kx = flash::load4(K + (k0 + r) * p.sk.s + 4 * cc);
        vx = flash::load4(V + (k0 + r) * p.sv.s + 4 * cc);
      }
      *reinterpret_cast<float4*>(&sK[r * HD + 4 * cc]) = kx;
      *reinterpret_cast<float4*>(&sV[r * HD + 4 * cc]) = vx;
    }
    __syncthreads();

    for (int j0 = 0; j0 < BK; j0 += kFChunk) {
      float s[kFChunk];
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < kFChunk; ++jj) {
        const float* krow = &sK[(j0 + jj) * HD + 4 * t];
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < C4; ++i) {
          const float4 kv = *reinterpret_cast<const float4*>(krow + 4 * TPR * i);
          d = fmaf(q[4 * i + 0], kv.x, d);
          d = fmaf(q[4 * i + 1], kv.y, d);
          d = fmaf(q[4 * i + 2], kv.z, d);
          d = fmaf(q[4 * i + 3], kv.w, d);
        }
        d = flash::row_sum<TPR>(d);
        s[jj] = visible(p, qpos, k0 + j0 + jj) ? d : kNegInf;
        mx = fmaxf(mx, s[jj]);
      }
      const float corr = expf(m - mx);
      m = mx;
      l *= corr;
#pragma unroll
      for (int d = 0; d < 4 * C4; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < kFChunk; ++jj) {
        const float pe = k0 + j0 + jj < p.Skv ? expf(s[jj] - m) : 0.f;
        l += pe;
        const float* vrow = &sV[(j0 + jj) * HD + 4 * t];
#pragma unroll
        for (int i = 0; i < C4; ++i) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + 4 * TPR * i);
          acc[4 * i + 0] = fmaf(pe, vv.x, acc[4 * i + 0]);
          acc[4 * i + 1] = fmaf(pe, vv.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(pe, vv.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(pe, vv.w, acc[4 * i + 3]);
        }
      }
    }
    __syncthreads();
  }

  if (qi < p.Sq) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < C4; ++i)
      flash::store4(O + qi * p.so.s + 4 * (TPR * i + t),
                    make_float4(acc[4 * i] * inv, acc[4 * i + 1] * inv,
                                acc[4 * i + 2] * inv, acc[4 * i + 3] * inv));
    if (p.lse != nullptr && t == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + qi] =
          m + logf(fmaxf(l, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// fp32 SIMT kernel at the MLA layout: one k / v head shared by q's heads
// ---------------------------------------------------------------------------

namespace mla {
constexpr int kDK = 576;             // q / k head dim (kv_lora_rank + rope)
constexpr int kDV = 512;             // v head dim (kv_lora_rank)
constexpr int kThreads = 256;
constexpr int kBM = 64;              // rows (q position, head) a block
constexpr int kBN = 32;              // keys a tile
constexpr int kRows = 4;             // rows a thread (16 row groups)
constexpr int kCols = kDV / 4 / 16;  // float4 columns of O a thread (8)
constexpr int kStride = kDK + 4;     // floats a shared row: rows 4 banks apart
constexpr int kSmem = (kBM + kBN) * kStride * 4;  // Q rows, then K or V
}  // namespace mla

// Thread (ty, tx), ty = 2 warp + lane / 16, tx = lane % 16: rows 4 ty .. 4 ty
// + 3 of the block, keys tx and tx + 16 of each S tile, float4 columns tx +
// 16 c of O.  A row's 16 lanes are one half of a warp.
__global__ void __launch_bounds__(mla::kThreads, 1)
    flash_fwd_mla(const Params p, int n_rt, int B) {
  using namespace mla;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                    // kBM rows of kStride
  float* sKV = smem + kBM * kStride;   // kBN rows of kStride

  const int b = blockIdx.x % B;
  const int rt = n_rt - 1 - blockIdx.x / B;  // heaviest row tiles first
  const int n_rows = p.Sq * p.H;
  const int r0 = rt * kBM;
  const int lane = threadIdx.x % 32;
  const int ty = 2 * (threadIdx.x / 32) + lane / 16, tx = lane % 16;

  const float* Q = static_cast<const float*>(p.q) + b * p.sq.b;
  const float* K = static_cast<const float*>(p.k) + b * p.sk.b;
  const float* V = static_cast<const float*>(p.v) + b * p.sv.b;
  float* O = static_cast<float*>(p.o) + b * p.so.b;

  // q, scaled as the plain version scales it, resident for every key tile
  for (int c = threadIdx.x; c < kBM * (kDK / 4); c += kThreads) {
    const int r = c / (kDK / 4), f4 = c % (kDK / 4), row = r0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n_rows) {
      x = flash::load4(Q + (row / p.H) * p.sq.s + (row % p.H) * p.sq.h +
                       4 * f4);
      x = make_float4(x.x * p.scale, x.y * p.scale, x.z * p.scale,
                      x.w * p.scale);
    }
    *reinterpret_cast<float4*>(&sQ[r * kStride + 4 * f4]) = x;
  }

  int qpos[kRows];
  float m[kRows], l[kRows];
  float4 acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = r0 + 4 * ty + i;
    qpos[i] = row < n_rows ? row / p.H + p.q_offset : -1;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  int lo, hi;
  const int i_first = r0 / p.H, i_last = (min(r0 + kBM, n_rows) - 1) / p.H;
  flash::kv_range(p.Sq, p.Skv, p.causal, p.window, p.q_offset, i_first,
                  i_last - i_first + 1, kBN, lo, hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kBN;
    __syncthreads();  // the last tile's V is read; sQ is written
    for (int c = threadIdx.x; c < kBN * (kDK / 4); c += kThreads) {
      const int r = c / (kDK / 4), f4 = c % (kDK / 4);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < p.Skv) x = flash::load4(K + (k0 + r) * p.sk.s + 4 * f4);
      *reinterpret_cast<float4*>(&sKV[r * kStride + 4 * f4]) = x;
    }
    __syncthreads();

    // S = (q scale) k^T for 4 rows x 2 keys, over the 576 features
    float s[kRows][2];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i][0] = s[i][1] = 0.f;
    const float* qrow = &sQ[4 * ty * kStride];
#pragma unroll 4
    for (int f = 0; f < kDK; f += 4) {
      const float4 k0v = *reinterpret_cast<const float4*>(&sKV[tx * kStride + f]);
      const float4 k1v =
          *reinterpret_cast<const float4*>(&sKV[(tx + 16) * kStride + f]);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&qrow[i * kStride + f]);
        s[i][0] = fmaf(qv.x, k0v.x, s[i][0]);
        s[i][0] = fmaf(qv.y, k0v.y, s[i][0]);
        s[i][0] = fmaf(qv.z, k0v.z, s[i][0]);
        s[i][0] = fmaf(qv.w, k0v.w, s[i][0]);
        s[i][1] = fmaf(qv.x, k1v.x, s[i][1]);
        s[i][1] = fmaf(qv.y, k1v.y, s[i][1]);
        s[i][1] = fmaf(qv.z, k1v.z, s[i][1]);
        s[i][1] = fmaf(qv.w, k1v.w, s[i][1]);
      }
    }

    // the online softmax, a row over its 16 lanes; s becomes p
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (!flash::visible(p.Skv, p.causal, p.window, qpos[i],
                            k0 + tx + 16 * j))
          s[i][j] = kNegInf;
      float mx = fmaxf(s[i][0], s[i][1]);
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        s[i][j] = k0 + tx + 16 * j < p.Skv ? expf(s[i][j] - m_new) : 0.f;
      l[i] = l[i] * corr + flash::row_sum<16>(s[i][0] + s[i][1]);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        acc[i][c].x *= corr;
        acc[i][c].y *= corr;
        acc[i][c].z *= corr;
        acc[i][c].w *= corr;
      }
    }

    __syncthreads();  // every warp is done with the K tile
    for (int c = threadIdx.x; c < kBN * (kDV / 4); c += kThreads) {
      const int r = c / (kDV / 4), f4 = c % (kDV / 4);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < p.Skv) x = flash::load4(V + (k0 + r) * p.sv.s + 4 * f4);
      *reinterpret_cast<float4*>(&sKV[r * kStride + 4 * f4]) = x;
    }
    __syncthreads();

    // O += P V: key j's p of each row from the lane that holds it
#pragma unroll 4
    for (int j = 0; j < kBN; ++j) {
      float pj[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pj[i] = __shfl_sync(0xffffffffu, j < 16 ? s[i][0] : s[i][1],
                            (lane & 16) | (j & 15));
      const float* vrow = &sKV[j * kStride];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&vrow[4 * (tx + 16 * c)]);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          acc[i][c].x = fmaf(pj[i], vv.x, acc[i][c].x);
          acc[i][c].y = fmaf(pj[i], vv.y, acc[i][c].y);
          acc[i][c].z = fmaf(pj[i], vv.z, acc[i][c].z);
          acc[i][c].w = fmaf(pj[i], vv.w, acc[i][c].w);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = r0 + 4 * ty + i;
    if (row >= n_rows) continue;
    const int qi = row / p.H, h = row % p.H;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* orow = O + qi * p.so.s + h * p.so.h;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      flash::store4(orow + 4 * (tx + 16 * c),
                    make_float4(acc[i][c].x * inv, acc[i][c].y * inv,
                                acc[i][c].z * inv, acc[i][c].w * inv));
    if (p.lse != nullptr && tx == 0)
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + qi] =
          m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// bf16 at the MLA layout: TMA + wgmma, 64 heads of a position a block
// ---------------------------------------------------------------------------

namespace mla_tc {
constexpr int kBM = 64;                         // rows (q position, head) a block
constexpr int kBN = 64;                         // keys a tile
constexpr int kThreads = 256;                   // two consumer warpgroups
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kBoxBytes = 64 * 128;        // 64 rows of one 64-column box
constexpr int kQKBoxes = mla::kDK / kBox;       // 9
constexpr int kVBoxes = mla::kDV / kBox;        // 8
constexpr uint32_t kQKBytes = kQKBoxes * kBoxBytes;  // Q or a K tile: 72 KB
constexpr uint32_t kVBytes = kVBoxes * kBoxBytes;    // a V tile: 64 KB
}  // namespace mla_tc

// The shared-memory layout, in bytes from a 1024-byte-aligned base: Q, the
// K stages, the V stage (a separate v only), the P exchange (8 uint32 a
// thread), the row maxima and sums of both warpgroups, then the full
// mbarriers and the release counters (8 bytes each).
template <bool kSharedKV>
struct MlaCfg {
  static constexpr int kKStages = kSharedKV ? 2 : 1;
  static constexpr uint32_t kK = mla_tc::kQKBytes;  // stage st: + st * kQKBytes
  static constexpr uint32_t kV = kK + kKStages * mla_tc::kQKBytes;
  static constexpr uint32_t kX = kV + (kSharedKV ? 0 : mla_tc::kVBytes);
  static constexpr uint32_t kMax = kX + 2 * 8 * 128 * 4;
  static constexpr uint32_t kSum = kMax + 2 * 64 * 4;
  static constexpr uint32_t kQFull = kSum + 2 * 64 * 4;
  static constexpr uint32_t kKFull = kQFull + 8;           // stage st: + 8 st
  static constexpr uint32_t kVFull = kKFull + 8 * kKStages;
  static constexpr uint32_t kKEmpty = kVFull + 8;          // stage st: + 8 st
  static constexpr uint32_t kVEmpty = kKEmpty + 8 * kKStages;
  static constexpr int kSmem = 1024 + kVEmpty + 8;         // + alignment
};

// NB boxes of 64 rows from row `row` of `map` (over (features, rows, 1,
// B)) into `dst`, announced on `full`; by one thread.
template <int NB>
__device__ __forceinline__ void load_rows(const CUtensorMap* map, uint32_t dst,
                                          uint32_t full, int row, int b) {
  mbar_expect_tx(full, NB * mla_tc::kBoxBytes);
  for (int c = 0; c < NB; ++c)
    tma_load(dst + c * mla_tc::kBoxBytes, map, full, c * kBox, row, 0, b);
}

// S = Q K^T for warpgroup WG's keys [32 WG, 32 WG + 32) of the tile: 64 x
// 32 over the 576 features, both operands K-major.  Issued, not waited for.
// Each k step's descriptors are the first ones plus its offset (in 16-byte
// units; no carry leaves the address field), and the addresses pass through
// an opaque move: left to itself, ptxas keeps the 36 descriptors of an
// address that does not change over the key loop (Q's; a single K stage's)
// in registers across it and spills.
template <int WG>
__device__ __forceinline__ void issue_qk_mla(float (&s)[16], uint32_t q,
                                             uint32_t k_tile) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(q));
  asm volatile("mov.b32 %0, %0;\n" : "+r"(k_tile));
  const uint64_t dq = sw128_desc(q, 16, 1024);
  const uint64_t dk = sw128_desc(k_tile + WG * 32 * 128, 16, 1024);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * mla_tc::kQKBoxes; ++kk) {
    const uint32_t off = ((kk / 4) * mla_tc::kBoxBytes + (kk % 4) * 32) >> 4;
    wgmma_ss(s, dq + off, dk + off, kk > 0);
  }
  wgmma_commit();
}

// O[:, 256 WG + (0..255)] += P V over the tile's 64 keys, P as the sum of
// its bf16 high and low parts (ph, pl): V is [key][512], read MN-major,
// WG's four boxes from the tile's box 4 WG.  Issued, not waited for.
template <int WG>
__device__ __forceinline__ void issue_pv_mla(float (&o)[128],
                                             const uint32_t (&ph)[4][4],
                                             const uint32_t (&pl)[4][4],
                                             uint32_t v_tile) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(v_tile));
  reg_fence(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t dv =
        sw128_desc(v_tile + 4 * WG * mla_tc::kBoxBytes + kk * 2048,
                   mla_tc::kBoxBytes, 1024);
    wgmma_rs(o, ph[kk], dv);
    wgmma_rs(o, pl[kk], dv);
  }
  wgmma_commit();
}

// Warpgroup WG of a block of rows [r0, r0 + 64): S for its 32 keys of each
// tile, the softmax of those with the row max shared, O for its 256
// columns.  Thread tid of either warpgroup holds rows row_l and row_l + 8.
template <bool kSharedKV, int WG>
__device__ __forceinline__ void consume_mla(const Params& p,
                                            const CUtensorMap* tk,
                                            const CUtensorMap* tv,
                                            uint32_t base, uint8_t* smem,
                                            int b, int r0, int lo,
                                            int n_tiles, int q_first,
                                            int q_last) {
  using C = MlaCfg<kSharedKV>;
  using namespace mla_tc;
  const int tid = threadIdx.x % 128, lane = threadIdx.x % 32, t = lane % 4;
  const int row_l = 16 * (tid / 32) + lane / 4;
  const int n_rows = p.Sq * p.H;
  float* smax = reinterpret_cast<float*>(smem + C::kMax);   // [WG][64]
  float* ssum = reinterpret_cast<float*>(smem + C::kSum);   // [WG][64]
  uint32_t* xch = reinterpret_cast<uint32_t*>(smem + C::kX);  // [WG][8][128]
  auto k_tile = [&](int it) {
    return base + C::kK + (it % C::kKStages) * kQKBytes;
  };
  auto v_tile = [&](int it) { return kSharedKV ? k_tile(it) : base + C::kV; };
  // The warp is done with tile it's K stage (with P V, where it is also V):
  // the last of the 8 warps loads the tile kKStages ahead into it.
  auto release_k = [&](int it) {
    const int st = it % C::kKStages;
    __syncwarp();
    if (release_last<kWarps>(base + C::kKEmpty + 8 * st) &&
        it + C::kKStages < n_tiles && lane == 0)
      load_rows<kQKBoxes>(tk, k_tile(it), base + C::kKFull + 8 * st,
                          (lo + it + C::kKStages) * kBN, b);
  };
  // A separate v: the warp is done with V tile it; the last loads it + 1.
  auto release_v = [&](int it) {
    __syncwarp();
    if (release_last<kWarps>(base + C::kVEmpty) && it + 1 < n_tiles &&
        lane == 0)
      load_rows<kVBoxes>(tv, base + C::kV, base + C::kVFull,
                         (lo + it + 1) * kBN, b);
  };

  const float scale_log2 = p.scale * kLog2e;  // softmax in base 2

  float o[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
  // P of the tile as A fragments, 16 keys a k step: its bf16 high part and
  // the bf16 rounding of the rest, so P V sees P to ~2^-17 (as the fp32
  // plain twin computes it) and not to bf16's 2^-9
  uint32_t ph[4][4], pl[4][4];

  // The softmax of S tile `it` (this warpgroup's 32 keys) in place, the row
  // max of all 64 keys through shared memory, corr the factor that rescales
  // O; then P into ph and pl, both halves.  The halves cross in the
  // fragment layout through one 8 KB buffer, high parts then low parts.
  auto softmax = [&](float (&s)[16], int it) {
    const int k0 = (lo + it) * kBN;
    const bool masked = k0 + kBN > p.Skv ||
                        (p.causal && k0 + kBN - 1 > q_first) ||
                        (p.window > 0 && q_last - k0 >= p.window);
    if (masked) {
      // keys visible to rows row_l and row_l + 8: [klo, khi); a row past
      // Sq H (zeros, not stored) takes the last row's
      int klo[2], khi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qpos =
            min(r0 + row_l + 8 * r, n_rows - 1) / p.H + p.q_offset;
        khi[r] = p.causal ? min(qpos + 1, p.Skv) : p.Skv;
        klo[r] = p.window > 0 ? qpos - p.window + 1 : 0;
      }
      const int c0 = k0 + 32 * WG + 2 * t;  // this thread's first column
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * j + (e & 1), r = e >> 1;
          s[4 * j + e] = col >= klo[r] && col < khi[r]
                             ? s[4 * j + e] * scale_log2
                             : -INFINITY;
        }
    } else {
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] *= scale_log2;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // a row lives on the 4 lanes of a quad
      float mx = fmaxf(fmaxf(s[2 * r], s[2 * r + 1]),
                       fmaxf(s[4 + 2 * r], s[5 + 2 * r]));
      mx = fmaxf(mx, fmaxf(fmaxf(s[8 + 2 * r], s[9 + 2 * r]),
                           fmaxf(s[12 + 2 * r], s[13 + 2 * r])));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      if (t == 0) smax[64 * WG + row_l + 8 * r] = mx;
    }
    bar_sync(1);  // both halves' maxima are in
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the same order in both warpgroups
      const int row = row_l + 8 * r;
      const float mx = fmaxf(m[r], fmaxf(smax[row], smax[64 + row]));
      corr[r] = exp2_approx(m[r] - mx);
      m[r] = mx;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = exp2_approx(s[i] - m[(i >> 1) & 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r)  // per-lane partial sums; quad-reduced at the end
      l[r] = l[r] * corr[r] +
             ((s[2 * r] + s[2 * r + 1]) + (s[4 + 2 * r] + s[5 + 2 * r]) +
              ((s[8 + 2 * r] + s[9 + 2 * r]) + (s[12 + 2 * r] + s[13 + 2 * r])));
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = s[8 * kk + 2 * i], c = s[8 * kk + 2 * i + 1];
        const uint32_t h = pack_bf16(a, c);
        ph[2 * WG + kk][i] = h;
        pl[2 * WG + kk][i] = pack_bf16(a - __uint_as_float(h << 16),
                                       c - __uint_as_float(h & 0xffff0000u));
        xch[(8 * WG + 4 * kk + i) * 128 + tid] = h;
      }
    bar_sync(1);  // both halves' high parts are in
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ph[2 * (1 - WG) + kk][i] = xch[(8 * (1 - WG) + 4 * kk + i) * 128 + tid];
    bar_sync(1);  // both are read: the buffer takes the low parts
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xch[(8 * WG + 4 * kk + i) * 128 + tid] = pl[2 * WG + kk][i];
    bar_sync(1);  // both halves' low parts are in
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pl[2 * (1 - WG) + kk][i] = xch[(8 * (1 - WG) + 4 * kk + i) * 128 + tid];
  };
  auto rescale = [&] {
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] *= corr[(i >> 1) & 1];
  };

  mbar_wait(base + C::kQFull, 0);
  if (n_tiles > 0) {
    {  // tile 0: S only
      float s[16];
      mbar_wait(base + C::kKFull, 0);
      issue_qk_mla<WG>(s, base, k_tile(0));
      wgmma_wait<0>();
      reg_fence(s);
      if (!kSharedKV) release_k(0);
      softmax(s, 0);
    }
    for (int it = 1; it < n_tiles; ++it) {
      float s[16];
      mbar_wait(base + C::kKFull + 8 * (it % C::kKStages),
                (it / C::kKStages) & 1);
      if (!kSharedKV) mbar_wait(base + C::kVFull, (it - 1) & 1);
      issue_pv_mla<WG>(o, ph, pl, v_tile(it - 1));
      issue_qk_mla<WG>(s, base, k_tile(it));
      wgmma_wait<1>();  // P V of tile it - 1: its V, ph and pl are free
      reg_fence(o);
      if (kSharedKV)
        release_k(it - 1);
      else
        release_v(it - 1);
      wgmma_wait<0>();  // S of tile it
      reg_fence(s);
      if (!kSharedKV) release_k(it);
      softmax(s, it);
      rescale();
    }
    if (!kSharedKV) mbar_wait(base + C::kVFull, (n_tiles - 1) & 1);
    issue_pv_mla<WG>(o, ph, pl, v_tile(n_tiles - 1));  // the last tile's P V
    wgmma_wait<0>();
    reg_fence(o);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (t == 0) ssum[64 * WG + row_l + 8 * r] = l[r];
  }
  bar_sync(1);  // both halves' sums are in
  auto* O = static_cast<__nv_bfloat16*>(p.o) + b * p.so.b;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + row_l + 8 * r;
    if (row >= n_rows) continue;
    const int qi = row / p.H, h = row % p.H;
    const float lt = ssum[row_l + 8 * r] + ssum[64 + row_l + 8 * r];
    if (p.lse != nullptr && WG == 0 && t == 0)  // m is in base 2
      p.lse[(static_cast<long long>(b) * p.H + h) * p.Sq + qi] =
          m[r] * kLn2 + logf(fmaxf(lt, 1e-30f));
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    __nv_bfloat16* orow = O + qi * p.so.s + h * p.so.h + 256 * WG + 2 * t;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
  }
}

template <bool kSharedKV>
__global__ void __launch_bounds__(mla_tc::kThreads, 1)
    flash_fwd_mla_bf16(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const Params p,
                       int n_rt, int B) {
  using C = MlaCfg<kSharedKV>;
  using namespace mla_tc;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - smem_addr(smem_raw));

  const int b = blockIdx.x % B;
  const int r0 = (n_rt - 1 - blockIdx.x / B) * kBM;  // heaviest row tiles first
  const int n_rows = p.Sq * p.H;
  const int i_first = r0 / p.H, i_last = (min(r0 + kBM, n_rows) - 1) / p.H;
  int lo, hi;
  flash::kv_range(p.Sq, p.Skv, p.causal, p.window, p.q_offset, i_first,
                  i_last - i_first + 1, kBN, lo, hi);
  const int n_tiles = max(hi - lo, 0);  // tile it is key tile lo + it

  if (threadIdx.x == 0) {
    mbar_init(base + C::kQFull, 1);
    mbar_init(base + C::kVFull, 1);
    *reinterpret_cast<uint32_t*>(smem + C::kVEmpty) = 0;
    for (int st = 0; st < C::kKStages; ++st) {
      mbar_init(base + C::kKFull + 8 * st, 1);
      *reinterpret_cast<uint32_t*>(smem + C::kKEmpty + 8 * st) = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {  // Q and the first tiles; the consumers refill
    load_rows<kQKBoxes>(&tq, base, base + C::kQFull, r0, b);
    for (int it = 0; it < min(n_tiles, C::kKStages); ++it)
      load_rows<kQKBoxes>(&tk, base + C::kK + it * kQKBytes,
                          base + C::kKFull + 8 * it, (lo + it) * kBN, b);
    if (!kSharedKV && n_tiles > 0)
      load_rows<kVBoxes>(&tv, base + C::kV, base + C::kVFull, lo * kBN, b);
  }
  // the role from a warp-uniform warp index, so the branches are uniform
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int q_first = i_first + p.q_offset, q_last = i_last + p.q_offset;
  if (warp < 4)
    consume_mla<kSharedKV, 0>(p, &tk, &tv, base, smem, b, r0, lo, n_tiles,
                              q_first, q_last);
  else
    consume_mla<kSharedKV, 1>(p, &tk, &tv, base, smem, b, r0, lo, n_tiles,
                              q_first, q_last);
}

// The fp32 SIMT kernel, or the bf16 wgmma kernel whose K tile serves as V
// (shared_kv: v is k's first 512 features, as the wrapper checks) or which
// loads its own V tiles.  q's rows (position, head) must lie at one stride
// for the bf16 kernel's map: H times the head stride apart a position.
int launch_mla(const Params& p, int dtype, int shared_kv, int B,
               cudaStream_t stream) {
  const long long n_rows = static_cast<long long>(p.Sq) * p.H;
  const long long n_rt = (n_rows + mla::kBM - 1) / mla::kBM;
  if (n_rows > INT_MAX || n_rt * B > INT_MAX)
    return (int)cudaErrorInvalidConfiguration;
  const unsigned blocks = static_cast<unsigned>(n_rt * B);
  if (dtype == 0) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(&flash_fwd_mla),
        cudaFuncAttributeMaxDynamicSharedMemorySize, mla::kSmem);
    if (err != cudaSuccess) return (int)err;
    flash_fwd_mla<<<blocks, mla::kThreads, mla::kSmem, stream>>>(
        p, static_cast<int>(n_rt), B);
    return (int)cudaGetLastError();
  }
  if (dtype != 1 || (p.H > 1 && p.Sq > 1 && p.sq.s != p.H * p.sq.h) ||
      (shared_kv && (p.v != p.k || p.sv.b != p.sk.b || p.sv.s != p.sk.s)))
    return (int)cudaErrorInvalidValue;
  const flash::Strides rows = {p.sq.b, p.H > 1 ? p.sq.h : p.sq.s, 0};
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, p.q, mla::kDK, static_cast<int>(n_rows), 1, B, rows,
                mla_tc::kBM) ||
      !make_map(&tk, p.k, mla::kDK, p.Skv, 1, B, p.sk, mla_tc::kBN) ||
      !make_map(&tv, p.v, mla::kDV, p.Skv, 1, B, p.sv, mla_tc::kBN))
    return (int)cudaErrorInvalidValue;
  const void* fn = shared_kv
                       ? reinterpret_cast<const void*>(&flash_fwd_mla_bf16<true>)
                       : reinterpret_cast<const void*>(&flash_fwd_mla_bf16<false>);
  const int smem = shared_kv ? MlaCfg<true>::kSmem : MlaCfg<false>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (shared_kv)
    flash_fwd_mla_bf16<true><<<blocks, mla_tc::kThreads, smem, stream>>>(
        tq, tk, tv, p, static_cast<int>(n_rt), B);
  else
    flash_fwd_mla_bf16<false><<<blocks, mla_tc::kThreads, smem, stream>>>(
        tq, tk, tv, p, static_cast<int>(n_rt), B);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16(const Params& p, int B, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, p.q, HD, p.Sq, p.H, B, p.sq, kBQ) ||
      !make_map(&tk, p.k, HD, p.Skv, p.H, B, p.sk, Cfg<HD>::kBK) ||
      !make_map(&tv, p.v, HD, p.Skv, p.H, B, p.sv, Cfg<HD>::kBK))
    return (int)cudaErrorInvalidValue;
  const long long blocks =
      static_cast<long long>(B) * p.H * ((p.Sq + kBQ - 1) / kBQ);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(&flash_fwd_bf16<HD>),
      cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<HD>::kSmem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_bf16<HD><<<static_cast<unsigned>(blocks), Cfg<HD>::kThreads,
                       Cfg<HD>::kSmem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

template <int HD, typename T>
int launch_simt(const Params& p, int B, cudaStream_t stream) {
  const int n_qt = (p.Sq + Simt<HD>::kBQ - 1) / Simt<HD>::kBQ;
  if (n_qt > 65535) return (int)cudaErrorInvalidConfiguration;
  flash_fwd_simt<HD, T><<<dim3(B * p.H, n_qt), kFThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const Params& p, int dtype, int B, cudaStream_t stream) {
  if (dtype == 0) return launch_simt<HD, float>(p, B, stream);
  if constexpr (HD >= 64)
    return launch_bf16<HD>(p, B, stream);
  else
    return launch_simt<HD, __nv_bfloat16>(p, B, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  hd: 16, 32, 64, 128 or 256.  Strides
// are in elements, as (batch, seq, head); the head_dim stride must be 1.
// window <= 0 means no window.  lse: (B, H, Sq) fp32, or null for none.
// Returns cudaGetLastError() after the launch (0 = success), or
// cudaErrorInvalidValue for an unsupported dtype / head dim or when a bf16
// tensor map cannot be built.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int dtype, int B, int H, int Sq, int Skv, int hd, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, int causal, int window,
    int q_offset, float scale, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.sq = {q_sb, q_ss, q_sh};
  p.sk = {k_sb, k_ss, k_sh};
  p.sv = {v_sb, v_ss, v_sh};
  p.so = {o_sb, o_ss, o_sh};
  p.H = H;
  p.Sq = Sq;
  p.Skv = Skv;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.scale = scale;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
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

// The MLA layout: q (B, Sq, H, 576), k (B, Skv, 1, 576), v (B, Skv, 1,
// 512), o (B, Sq, H, 512); strides in elements as above, without k's and
// v's head strides.  dtype 0 (float32) runs the SIMT kernel flash_fwd_mla,
// 1 (bfloat16) flash_fwd_mla_bf16: with shared_kv, v must be k's first 512
// features (the same pointer and strides) and the K tile serves as V, and
// q's position stride must be H times its head stride (where H > 1 and Sq
// > 1).  Masks, scale, lse and the return value as flash_attention_fwd;
// cudaErrorInvalidValue where the layout does not hold.
extern "C" int flash_attention_mla_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int dtype, int shared_kv, int B, int H, int Sq, int Skv, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long v_sb, long long v_ss, long long o_sb, long long o_ss,
    long long o_sh, int causal, int window, int q_offset, float scale,
    void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.sq = {q_sb, q_ss, q_sh};
  p.sk = {k_sb, k_ss, 0};
  p.sv = {v_sb, v_ss, 0};
  p.so = {o_sb, o_ss, o_sh};
  p.H = H;
  p.Sq = Sq;
  p.Skv = Skv;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.scale = scale;
  return launch_mla(p, dtype, shared_kv, B, static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
