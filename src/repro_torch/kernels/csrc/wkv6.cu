// WKV6 (the RWKV6 "Finch" time-mix recurrence) for Hopper (sm_90a), forward
// and backward, bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel `_wkv_kernel` behind `wkv6` in
// src/repro/kernels/rwkv6.py.  Per (batch, head), with an (hd, hd) fp32
// state S:
//     y_t = r_t (S + diag(u) k_t^T v_t),   S <- diag(w_t) S + k_t^T v_t.
// Unlike the TPU kernel it takes an initial state s0 and writes the final
// state, accepts any S >= 1 (the ragged last chunk is masked here), reads
// (B, S, H, hd) through the caller's strides (no moveaxis copies), and
// stays finite at any decay: it never forms a ratio of cumulative decays,
// so there is no exp(+x) that can overflow (the TPU kernel's mid-chunk
// normalisation overflows fp32 once half a chunk's summed -log w passes
// ~88).
//
// Bounds at the serving path's prefill shape (B=4, S=2048, H=40, hd=64,
// fp32, with s0) on an H100 SXM:
//  * bytes: r, k, v, w in and y out are 5 x 83.9 MB, plus 5.2 MB of state
//    in and out: 0.127 ms at 3.35 TB/s;
//  * instructions: the recurrence needs at least 3 fp32 instructions per
//    state element per token (k v, the state FMA, the output FMA), 126 M
//    warp instructions, ~0.14 ms at 132 SMs x 4 warp instructions per
//    clock x ~1.75 GHz.  As FLOP (4 B S H hd^2 = 5.4 GFLOP) it is 0.08 ms at
//    67 TFLOP/s fp32.
// The kernel keeps the sequential fp32 recurrence (tf32 tensor cores would
// miss the 1e-4 bar) and works on both bounds: every input byte is read
// from device memory once (the second column block of a head finds r, k,
// w in L2), under the walk; the walk spends 4 fp32 instructions per state
// element and token (the folded bonus adds one to the floor's 3), plus
// ~1.2 for shared loads and the y reduction.  What binds it is the
// instruction rate and shared-memory bandwidth, not bytes.
//
// Design:
//  * Column j of S depends only on v[:, j], so the grid is
//    (B*H, hd / VT): each block owns VT value columns of one head.  A
//    thread holds ROWS rows of COLS columns in registers (hd 64: 4 x 4);
//    the G = hd / ROWS threads of a column group are neighbouring lanes of
//    one warp.  COLS > 1 matters: a thread reads 3 ROWS + COLS floats of
//    shared memory a token for its ROWS x COLS state elements, and with
//    one column a thread the walk was bound by those reads (the times of
//    tools/wkv6_variants.py are in PERF.md).
//  * Staging ring.  Tokens are staged `chunk` at a time (the caller's
//    `chunk`, fewer where two stages would not fit in shared memory) into
//    a ring of kStages = 2 stages with cp.async: r, k, w (hd wide) and
//    v (VT wide) of chunk c+1 load while chunk c is walked, and one
//    barrier per chunk both publishes the arrived stage and frees the
//    one walked before.  Two copy paths, chosen per call by the wrapper:
//    16-byte `cp.async.cg` when every base pointer and (b, s, h) stride of
//    r, k, v, w is a multiple of 4 elements, else 4-byte `cp.async.ca`;
//    neighbouring threads copy neighbouring addresses on both.  Tokens
//    past S are never loaded or walked, and `chunk` does not change the
//    result.
//  * The bonus is folded into the walk.  Each thread keeps u for its rows
//    in registers and forms its part of y_j = sum_i r_i (S_ij + u_i k_i v_j)
//    with the state before the update, reusing k_i v_j for the update.
//  * y without shuffles on the chain.  A thread keeps its partial sums of
//    G consecutive tokens in registers; then one transposing butterfly
//    over the G lanes (G - 1 shuffles per column) leaves lane g with the
//    whole sum of token g, which it stores straight to y: the lanes of a
//    warp write whole 32-byte sectors.
//  * Residency.  At the prefill shape the grid is 320 blocks of 128
//    threads; a block's shared memory (two stages of 32 tokens, 2 x 28 KB,
//    plus the 8.3 KB state tile) stays under a third of an SM's 228 KB and
//    launch bounds cap registers at 170, so three blocks fit on every SM
//    and the whole grid is resident in one wave.
//  * Coalesced state.  s0 is copied (cp.async, lanes along j) into a
//    padded (VT, hd + 1) tile in shared memory and read from there; the
//    final state goes back through the same tile, so both cross device
//    memory as whole rows (lanes along j), and the padding keeps the
//    tile's column-wise copies free of bank conflicts.
//  * tools/wkv6_variants.py builds and times other hd-64 layouts and ring
//    depths (it edits the Pick<64> and kStages lines).
//  * Checkpoints for the backward.  Given a `ckpt` pointer (training), the
//    kernel also writes the state before tokens 0, 32, 64, ...
//    (kCkptEvery) to (B, H, ceil(S / 32), hd, hd).  They leave as the
//    final state does: at its token the state goes into the tile, and once
//    the group of G tokens is walked the block stores the tile as whole
//    rows (two barriers a checkpoint).  A runtime phase and direction
//    (Params) let the backward's reverse pass put its checkpoints on the
//    forward's span boundaries.  That is a template flag: serving passes
//    no pointer and runs the kernel built without it, and each launch site
//    has an entry of its own (`wkv6_kernel<K, false>` serving,
//    `wkv6_kernel<K, true>` training, `wkv6_rev_kernel<K>` the backward),
//    so a profile names the launch.
//
// The backward (`wkv6_bwd`) has no TPU counterpart: the JAX package
// differentiates the `lax.scan` of src/repro/models/blocks.py:381.  With
// G_t = dL/dS_t, G_T = ds_final, walking t from T down to 1:
//     dr_t[i] = sum_j dy_t[j] S_{t-1}[i,j] + u[i] k_t[i] (dy_t . v_t)
//     dk_t[i] = sum_j G_t[i,j] v_t[j]      + u[i] r_t[i] (dy_t . v_t)
//     dv_t[j] = sum_i k_t[i] G_t[i,j]      + dy_t[j] sum_i r_t[i] u[i] k_t[i]
//     dw_t[i] = sum_j G_t[i,j] S_{t-1}[i,j]
//     du[i]  += r_t[i] k_t[i] (dy_t . v_t)
//     G_{t-1} = diag(w_t) G_t + r_t^T dy_t,   ds0 = G_0.
// dw needs S_{t-1} and G_t at the same step.  S_{t-1} is never recovered by
// running the state backwards ((S_t - k^T v) / w) nor dw from log-space
// sums divided by w: w reaches 1e-6 and below, and fp32 would turn that
// division into O(0.1) errors.  Every walk here multiplies by w <= 1 only,
// in fp32 (tf32 tensor cores would miss the 1e-4 bar).
// Bound at the training step's shape (B=4, S=2048, H=40, hd=64, fp32, as
// chip_smoke.py counts it): bytes, r, k, v, w and dy read and dr, dk, dv,
// dw written (9 x 83.9 MB) plus the 168 MB of checkpoints read, 0.275 ms
// at 3.35 TB/s; operations, 14 B S H hd^2 = 18.8 GFLOP (3 each for the
// state's recompute and G's update, 2 each for dr, dk, dv, dw, per state
// element and token), 0.2805 ms at 67 TFLOP/s fp32.  The bound is 0.2805
// ms, operations.
// Three launches, no atomics (two calls give equal bits):
//  * The reverse pass (`wkv6_rev_kernel`): dv_t = k_t (G_t + diag(u)
//    r_t^T dy_t) and G_{t-1} = diag(w_t) G_t + r_t^T dy_t are the forward
//    recurrence with r and k swapped, v -> dy and s0 -> ds_final, run from
//    the last token to the first: the checkpointing forward itself, on
//    pointers that start at token S - 1 with negated token strides.  Its y
//    is dv, its final state ds0, and its checkpoints, phased to the
//    forward's span boundaries and stored last slot first, are G after
//    every span of kCkptEvery tokens ((B, H, nck, hd, hd) scratch).
//  * The span walk (`wkv6_pair_kernel`, below its own header): with both
//    checkpoints every span of 32 tokens is independent, so a block owns
//    one span of one head (64 rows, one thread a row at hd 64) and no
//    block waits for another (10,240 blocks at the training shape: many
//    waves, and no chain as long as the sequence).  Inside the span it
//    regroups the recurrence's sums by token pairs: per row and token ~2
//    hd operations (the checkpoint rows against dy and v), and ~6 per pair
//    of tokens, against ~7 hd per row and token for walking S and G
//    through the span, and no reduction across lanes.  Every factor is a
//    product of w; nothing is divided.  The block stages the span with
//    cp.async, forms M = dy v^T once, and writes dr, dk, dw as whole rows
//    a token.
//  * wkv6_du_kernel sums du over b and the spans, in a fixed order.
// tools/wkv6_bwd_variants.py builds and times other layouts of the span
// walk (it edits the PPick<64> line) beside an earlier wkv6.cu.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kStages = 2;
constexpr size_t kSmemMax = 227 * 1024;  // a block's opt-in shared memory
// Tokens between two of the forward's checkpoints (the state before tokens
// 0, kCkptEvery, 2 kCkptEvery, ...), which the backward walks back from.
// A constant of its own: the stage's `chunk` shrinks where two stages do
// not fit, and the checkpoints must not move with it.
constexpr int kCkptEvery = 32;

// ROWS state rows and COLS state columns a thread, VT columns a block, and
// the blocks an SM must hold (launch bounds: registers <= 64K / (MINB NT)).
template <int HD_, int ROWS_, int COLS_, int VT_, int MINB_>
struct Cfg {
  static constexpr int HD = HD_, ROWS = ROWS_, COLS = COLS_, VT = VT_;
  static constexpr int G = HD / ROWS;        // lanes per column group
  static constexpr int NT = G * VT / COLS;   // threads per block
  static constexpr int kMinBlocks = MINB_;
  static constexpr int kTokenFloats = 3 * HD + VT;  // r k w | v
  static constexpr int kTileFloats = (VT * (HD + 1) + 3) / 4 * 4;
  static_assert(ROWS % 4 == 0 && HD % ROWS == 0 && 32 % G == 0, "rows");
  static_assert(VT % 4 == 0 && HD % VT == 0 && VT % COLS == 0, "columns");
  static_assert(COLS == 1 || COLS == 2 || COLS == 4, "columns per thread");
  static_assert(NT % 32 == 0, "whole warps");
};

template <int HD>
struct Pick;
template <>
struct Pick<16> { using T = Cfg<16, 4, 2, 16, 2>; };
template <>
struct Pick<32> { using T = Cfg<32, 8, 2, 32, 2>; };
template <>
struct Pick<64> { using T = Cfg<64, 4, 4, 32, 3>; };
template <>
struct Pick<128> { using T = Cfg<128, 8, 2, 16, 2>; };

struct Params {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;   // (H, hd), contiguous
  const float* s0;  // (B, H, hd, hd), contiguous, or null for zeros
  float* y;         // 16-byte aligned, strides multiples of 4
  float* s_final;   // (B, H, hd, hd), contiguous
  float* ckpt;      // (B, H, nck, hd, hd), contiguous: the kCkpt kernel's
  long long sr[3], sk[3], sv[3], sw[3], sy[3];  // element strides of b, s, h
  int H, S;
  int nck;    // checkpoints a head
  int chunk;  // tokens per stage
  int vec;    // 1: 16-byte copies, 0: 4-byte copies
  // kCkpt: the state before token t is kept where (t + phase) % kCkptEvery
  // is 0, and before token 0, in slot (t + phase) / kCkptEvery, stored at
  // nck - 1 - slot where ck_back (the backward's reverse pass), else at
  // slot (the forward: phase 0)
  int phase, ck_back;
};

// One block's (batch, head): base pointers (the token strides are read
// from the kernel's parameters).
struct Head {
  const float *r, *k, *v, *w;
  float* y;
  float* ck;  // the head's first checkpoint, column j0 (kCkpt only)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int W>  // floats per copy: 4 (16 bytes, L2 only) or 1 (4 bytes)
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  if constexpr (W == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage layout, C tokens: r (C, HD) | k (C, HD) | w (C, HD) | v (C, VT).
template <class K, int W>
__device__ __forceinline__ void load_chunk(const Params& p, const Head& a,
                                           float* stage, int C, long long t0,
                                           int n, int j0) {
  float* rs = stage;
  float* ks = rs + C * K::HD;
  float* ws = ks + C * K::HD;
  float* vs = ws + C * K::HD;
  constexpr int Q = K::HD / W;
#pragma unroll 1
  for (int x = threadIdx.x; x < n * Q; x += K::NT) {
    const int t = x / Q, i = (x % Q) * W;
    const long long tt = t0 + t;
    cp_async<W>(rs + t * K::HD + i, a.r + tt * p.sr[1] + i);
    cp_async<W>(ks + t * K::HD + i, a.k + tt * p.sk[1] + i);
    cp_async<W>(ws + t * K::HD + i, a.w + tt * p.sw[1] + i);
  }
  constexpr int QV = K::VT / W;
#pragma unroll 1
  for (int x = threadIdx.x; x < n * QV; x += K::NT) {
    const int t = x / QV, jj = (x % QV) * W;
    cp_async<W>(vs + t * K::VT + jj, a.v + (t0 + t) * p.sv[1] + j0 + jj);
  }
}

template <class K>
__device__ __forceinline__ void load_chunk(const Params& p, const Head& a,
                                           float* stage, int C, long long t0,
                                           int n, int j0) {
  if (p.vec)
    load_chunk<K, 4>(p, a, stage, C, t0, n, j0);
  else
    load_chunk<K, 1>(p, a, stage, C, t0, n, j0);
}

template <int N>
__device__ __forceinline__ void load_cols(const float* s, float (&d)[N]) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(s);
    d[0] = x.x, d[1] = x.y, d[2] = x.z, d[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(s);
    d[0] = x.x, d[1] = x.y;
  } else {
    d[0] = s[0];
  }
}

template <int N>
__device__ __forceinline__ void store_cols(float* s, const float (&d)[N]) {
  if constexpr (N == 4)
    *reinterpret_cast<float4*>(s) = make_float4(d[0], d[1], d[2], d[3]);
  else if constexpr (N == 2)
    *reinterpret_cast<float2*>(s) = make_float2(d[0], d[1]);
  else
    s[0] = d[0];
}

// mask ? a : b, bitwise: a select the compiler cannot turn into an indexed
// load from the partial-sum array (which would put it in local memory).
__device__ __forceinline__ float pick(unsigned mask, float a, float b) {
  return __uint_as_float((__float_as_uint(a) & mask) |
                         (__float_as_uint(b) & ~mask));
}

// One step of the transposing butterfly over 2 O lanes and 2 O tokens, then
// the next: lanes with bit O keep tokens [O, 2 O) of the remaining block,
// the others [0, O), each summed with its partner's.
template <int O, int COLS, int G>
__device__ __forceinline__ void butterfly(float (&part)[COLS][G], int g) {
  if constexpr (O > 0) {
    const unsigned hi = (g & O) ? ~0u : 0u;
#pragma unroll
    for (int c = 0; c < COLS; ++c)
#pragma unroll
      for (int x = 0; x < O; ++x) {
        const float lo_v = part[c][x], hi_v = part[c][x + O];
        const float send = pick(hi, lo_v, hi_v);
        const float keep = pick(hi, hi_v, lo_v);
        part[c][x] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
    butterfly<O / 2>(part, g);
  }
}

// The state into the padded (VT, HD + 1) tile, thread (g, cg) its own
// elements (rows 4 (g + G q) + e, columns cg COLS + c).
template <class K>
__device__ __forceinline__ void state_to_tile(
    float* tile, int g, int cg, const float (&st)[K::COLS][K::ROWS]) {
#pragma unroll
  for (int c = 0; c < K::COLS; ++c)
#pragma unroll
    for (int q = 0; q < K::ROWS / 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tile[(cg * K::COLS + c) * (K::HD + 1) + 4 * (g + K::G * q) + e] =
            st[c][4 * q + e];
}

// The tile's VT columns of all HD rows to dst (row stride HD): lanes along
// j, so a warp stores whole rows.
template <class K>
__device__ __forceinline__ void tile_to_rows(const float* tile, float* dst) {
  for (int x = threadIdx.x; x < K::HD * K::VT; x += K::NT) {
    const int i = x / K::VT, jj = x % K::VT;
    dst[(long long)i * K::HD + jj] = tile[jj * (K::HD + 1) + i];
  }
}

// Where checkpoint `slot` of the block's head and columns lies.
__device__ __forceinline__ float* ckpt_slot(const Params& p, const Head& a,
                                            long long slot, int hd) {
  return a.ck + (p.ck_back ? p.nck - 1 - slot : slot) * (long long)hd * hd;
}

// Walks tokens t0 .. t0 + m - 1 (m <= G; kFull: m == G) of one stage whose
// first token is `base` in the sequence, and stores their y.
// Thread (g, cg) holds rows 4 (g + G q) + e, q < ROWS / 4, e < 4, of
// columns cg COLS + c, c < COLS.  Each token's partial sums over the
// thread's rows stay in registers until the group ends; then one
// transposing butterfly over the G lanes sums them, leaving lane g with
// token t0 + g: G - 1 shuffles per column per group instead of
// log2(G) per column per token, and no shuffle on the walk's chain.
// kCkpt: a checkpoint falling in the group goes into the tile at its token
// and leaves once the group is walked.
template <class K, bool kFull, bool kCkpt>
__device__ __forceinline__ void walk_group(const Params& p, const Head& a,
                                           float* tile, long long base,
                                           int j0, const float* stage, int C,
                                           int t0, int m, int g, int cg,
                                           const float (&ur)[K::ROWS],
                                           float (&st)[K::COLS][K::ROWS]) {
  constexpr int HD = K::HD, VT = K::VT, G = K::G;
  constexpr int ROWS = K::ROWS, COLS = K::COLS;
  const float* rs = stage;
  const float* ks = rs + C * HD;
  const float* ws = ks + C * HD;
  const float* vs = ws + C * HD;
  // the group's first token, counted from the last checkpoint; the state
  // before token t0 + tc is a checkpoint (the group holds at most one)
  const int ck0 = kCkpt ? (int)((base + t0 + p.phase) % kCkptEvery) : 0;
  const int tc = (kCkptEvery - ck0) % kCkptEvery;
  float part[COLS][G];
#pragma unroll
  for (int tt = 0; tt < G; ++tt) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) part[c][tt] = 0.f;
    if (kFull || tt < m) {
      const int t = t0 + tt;
      if constexpr (kCkpt) {
        if (tt == tc) state_to_tile<K>(tile, g, cg, st);
      }
      const float4* r4 = reinterpret_cast<const float4*>(rs + t * HD) + g;
      const float4* k4 = reinterpret_cast<const float4*>(ks + t * HD) + g;
      const float4* w4 = reinterpret_cast<const float4*>(ws + t * HD) + g;
      float vj[COLS];
      load_cols<COLS>(vs + t * VT + cg * COLS, vj);
#pragma unroll
      for (int q = 0; q < ROWS / 4; ++q) {
        const float4 rr = r4[G * q], kk = k4[G * q], ww = w4[G * q];
        const float rv[4] = {rr.x, rr.y, rr.z, rr.w};
        const float kv4[4] = {kk.x, kk.y, kk.z, kk.w};
        const float wv[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = 4 * q + e;
#pragma unroll
          for (int c = 0; c < COLS; ++c) {
            const float kv = kv4[e] * vj[c];
            part[c][tt] =
                fmaf(rv[e], fmaf(ur[o], kv, st[c][o]), part[c][tt]);
            st[c][o] = fmaf(wv[e], st[c][o], kv);
          }
        }
      }
    }
  }
  butterfly<G / 2>(part, g);
  if (kFull || g < m) {
    float out[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) out[c] = part[c][0];
    store_cols<COLS>(a.y + (base + t0 + g) * p.sy[1] + j0 + cg * COLS, out);
  }
  if constexpr (kCkpt) {
    if (tc < m) {  // uniform: every thread of the block takes it or none
      __syncthreads();
      tile_to_rows<K>(
          tile, ckpt_slot(p, a, (base + t0 + tc + p.phase) / kCkptEvery, HD));
      __syncthreads();  // the tile is free again
    }
  }
}

// Walks the n tokens of one stage, G at a time.
template <class K, bool kCkpt>
__device__ __forceinline__ void walk(const Params& p, const Head& a,
                                     float* tile, long long base, int j0,
                                     const float* stage, int C, int n, int g,
                                     int cg, const float (&ur)[K::ROWS],
                                     float (&st)[K::COLS][K::ROWS]) {
  int t0 = 0;
#pragma unroll 1
  for (; t0 + K::G <= n; t0 += K::G)
    walk_group<K, true, kCkpt>(p, a, tile, base, j0, stage, C, t0, K::G, g,
                               cg, ur, st);
  if (t0 < n)
    walk_group<K, false, kCkpt>(p, a, tile, base, j0, stage, C, t0, n - t0,
                                g, cg, ur, st);
}

// kCkpt: also write the state every kCkptEvery tokens to p.ckpt (see
// Params); serving builds the kernel without it.
template <class K, bool kCkpt>
__device__ __forceinline__ void wkv6_body(const Params& p) {
  constexpr int HD = K::HD, VT = K::VT, G = K::G, NT = K::NT;
  constexpr int ROWS = K::ROWS, COLS = K::COLS;
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);  // (VT, HD + 1)
  float* ring = tile + K::kTileFloats;
  const int C = p.chunk, S = p.S;
  const int stage_floats = C * K::kTokenFloats;

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int j0 = blockIdx.y * VT;
  const int tid = threadIdx.x;
  const int g = tid % G, cg = tid / G;
  Head a;
  a.r = p.r + b * p.sr[0] + h * p.sr[2];
  a.k = p.k + b * p.sk[0] + h * p.sk[2];
  a.v = p.v + b * p.sv[0] + h * p.sv[2];
  a.w = p.w + b * p.sw[0] + h * p.sw[2];
  a.y = p.y + b * p.sy[0] + h * p.sy[2];
  const long long sbase = (long long)bh * HD * HD;
  a.ck = kCkpt ? p.ckpt + sbase * p.nck + j0 : nullptr;

  float ur[ROWS];
#pragma unroll
  for (int q = 0; q < ROWS / 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ur[4 * q + e] = p.u[(long long)h * HD + 4 * (g + G * q) + e];

  // Prologue: s0 into the tile, then the first kStages - 1 chunks.
  if (p.s0) {
    const float* s0b = p.s0 + sbase + j0;
    for (int x = tid; x < HD * VT; x += NT) {
      const int i = x / VT, jj = x % VT;
      cp_async<1>(tile + jj * (HD + 1) + i, s0b + (long long)i * HD + jj);
    }
  }
  cp_commit();
  const int nch = (S + C - 1) / C;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nch)
      load_chunk<K>(p, a, ring + s * stage_floats, C, (long long)s * C,
                    min(C, S - s * C), j0);
    cp_commit();
  }
  cp_wait<kStages - 1>();
  __syncthreads();
  // With a phase, token 0 is no multiple of kCkptEvery from the phase, and
  // the state before it (s0) goes to slot 0 here.  The tile is only read
  // until the walk's first barrier.
  if (kCkpt && p.phase) {
    float* dst = ckpt_slot(p, a, 0, HD);
    for (int x = tid; x < HD * VT; x += NT) {
      const int i = x / VT, jj = x % VT;
      dst[(long long)i * HD + jj] = p.s0 ? tile[jj * (HD + 1) + i] : 0.f;
    }
  }
  float st[COLS][ROWS];
#pragma unroll
  for (int c = 0; c < COLS; ++c)
#pragma unroll
    for (int q = 0; q < ROWS / 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st[c][4 * q + e] =
            p.s0 ? tile[(cg * COLS + c) * (HD + 1) + 4 * (g + G * q) + e]
                 : 0.f;

  for (int ci = 0; ci < nch; ++ci) {
    cp_wait<kStages - 2>();  // chunk ci has landed (this thread's copies)
    __syncthreads();         // ... everyone's; chunk ci - 1 is walked
    const int cn = ci + kStages - 1;  // into the stage chunk ci - 1 used
    if (cn < nch)
      load_chunk<K>(p, a, ring + (cn % kStages) * stage_floats, C,
                    (long long)cn * C, min(C, S - cn * C), j0);
    cp_commit();
    walk<K, kCkpt>(p, a, tile, (long long)ci * C, j0,
                   ring + (ci % kStages) * stage_floats, C,
                   min(C, S - ci * C), g, cg, ur, st);
  }

  // The final state leaves through the tile, whole rows at a time.
  state_to_tile<K>(tile, g, cg, st);
  __syncthreads();
  tile_to_rows<K>(tile, p.s_final + sbase + j0);
}

template <class K, bool kCkpt>
__global__ void __launch_bounds__(K::NT, K::kMinBlocks)
    wkv6_kernel(const __grid_constant__ Params p) {
  wkv6_body<K, kCkpt>(p);
}

// The backward's reverse pass: the checkpointing forward on the sequence
// walked back.  An entry of its own, so that a profile tells its launches
// from the forward's.
template <class K>
__global__ void __launch_bounds__(K::NT, K::kMinBlocks)
    wkv6_rev_kernel(const __grid_constant__ Params p) {
  wkv6_body<K, true>(p);
}

template <class K, class Kernel>
cudaError_t launch(Kernel kernel, Params p, int B, cudaStream_t stream) {
  const size_t token_bytes = sizeof(float) * K::kTokenFloats;
  const size_t tile_bytes = sizeof(float) * K::kTileFloats;
  const int fit = (int)((kSmemMax - tile_bytes) / (kStages * token_bytes));
  p.chunk = std::min(std::min(p.chunk, p.S), fit);
  const size_t smem = tile_bytes + kStages * p.chunk * token_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * p.H, K::HD / K::VT);
  kernel<<<grid, K::NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <class K>
cudaError_t launch_fwd(const Params& p, int B, cudaStream_t stream) {
  return p.ckpt ? launch<K>(wkv6_kernel<K, true>, p, B, stream)
                : launch<K>(wkv6_kernel<K, false>, p, B, stream);
}

// Whether a (B, S, H, hd) tensor allows 16-byte copies along hd: its base
// 16-byte aligned and each stride of a dimension longer than 1 a multiple
// of 4 elements.
bool aligned16(const void* ptr, const long long* st, int B, int S, int H) {
  const int dims[3] = {B, S, H};
  if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  for (int d = 0; d < 3; ++d)
    if (dims[d] > 1 && st[d] % 4) return false;
  return true;
}

struct BParams {
  const float *r, *k, *v, *w, *dy;
  const float* u;       // (H, hd), contiguous
  const float* ckpt;    // S before span c: (B, H, nck, hd, hd), contiguous
  const float* gck;     // G after span c (the reverse pass's), the same
  float *dr, *dk, *dw;  // (B, S, H, hd), strides so
  float* du_part;       // (B, H, nck, hd): du over each span
  long long sr[3], sk[3], sv[3], sw[3], sd[3], so[3];
  int H, S, nck;
  int vec;  // 1: 16-byte copies, 0: 4-byte copies
};

struct BHead {
  const float *r, *k, *v, *w, *dy;
};

// ---------------------------------------------------------------------------
// The span walk by token pairs (`wkv6_pair_kernel`).  In a span of L
// tokens, with S_a the state before it and G_b the gradient after it (the
// two checkpoints), write T[x][y] = w_{y+1} ... w_{x-1} (x > y; 1 for
// x = y + 1), E_t = w_0 ... w_{t-1}, F_t = w_{t+1} ... w_{L-1}, per row.
// Then, with M[x][y] = dy_x . v_y (per head), A_t = dy_t . S_a[i],
// B_t = v_t . G_b[i], Z = G_b[i] . S_a[i] (per row i), and
//     P_t[s] = sum_{y<t} T[t][y] k_y M[s][y]  (P_0 = 0,
//              P_{t+1}[s] = w_t P_t[s] + k_t M[s][t]),
//     Q_t = sum_{y<t} T[t][y] k_y B_y,   U_t = sum_{x>t} T[x][t] r_x A_x:
//  dr_t = E_t A_t + P_t[t] + u k_t c_t
//  dk_t = F_t B_t + sum_{s>t} T[s][t] r_s M[s][t] + u r_t c_t
//  dw_t = F_t E_t Z + F_t Q_t + E_t U_t + sum_{s>t} T[s][t] r_s P_t[s]
// (c_t = M[t][t]): the recurrence's sums regrouped by token pairs, every
// factor a product of w <= 1, nothing divided.  Per row and token that is
// ~2 HD operations for A and B and ~6 a pair for the rest, against ~7 HD
// for walking S and G through the span.  A block owns RB rows of one head
// and one span, one thread a row; tokens past the sequence's end are
// staged as w = 1 and zeros, which add nothing.
// ---------------------------------------------------------------------------

template <int HD_, int RB_, int MINB_>
struct PCfg {
  static constexpr int HD = HD_, RB = RB_, kMinBlocks = MINB_;
  static constexpr int NT = RB < 32 ? 32 : RB;  // threads past RB: M only
  static constexpr int L = kCkptEvery;
  static constexpr int HP = HD + 4;  // padded v and dy rows: lanes reading
                                     // rows x read other banks
  // r, k, w (L, RB) | v, dy (L, HP) | Mt (L, L), Mt[y][x] = M[x][y]; after
  // M and A, B: A, B (L, RB) over v and dy, U over w (each thread its own
  // column, once it holds its w)
  static constexpr int kFloats = 3 * L * RB + 2 * L * HP + L * L;
  static_assert(L == 32 && RB % 4 == 0 && HD % RB == 0, "rows");
  static_assert(NT == 32 || NT == 64, "threads");
};

template <int HD>
struct PPick;
template <>
struct PPick<16> { using T = PCfg<16, 16, 4>; };
template <>
struct PPick<32> { using T = PCfg<32, 32, 4>; };
template <>
struct PPick<64> { using T = PCfg<64, 64, 4>; };
template <>
struct PPick<128> { using T = PCfg<128, 64, 3>; };

template <class K, int W>
__device__ __forceinline__ void stage_pair(const BParams& p, const BHead& a,
                                           float* rs, float* ks, float* ws,
                                           float* vs, float* ds,
                                           long long ta, int n, int i0) {
  constexpr int RB = K::RB, HD = K::HD, HP = K::HP, L = K::L, NT = K::NT;
  constexpr int QR = RB / W, QV = HD / W;
#pragma unroll 1
  for (int x = threadIdx.x; x < n * QR; x += NT) {
    const int t = x / QR, i = (x % QR) * W;
    const long long tt = ta + t;
    cp_async<W>(rs + t * RB + i, a.r + tt * p.sr[1] + i0 + i);
    cp_async<W>(ks + t * RB + i, a.k + tt * p.sk[1] + i0 + i);
    cp_async<W>(ws + t * RB + i, a.w + tt * p.sw[1] + i0 + i);
  }
#pragma unroll 1
  for (int x = threadIdx.x; x < n * QV; x += NT) {
    const int t = x / QV, j = (x % QV) * W;
    const long long tt = ta + t;
    cp_async<W>(vs + t * HP + j, a.v + tt * p.sv[1] + j);
    cp_async<W>(ds + t * HP + j, a.dy + tt * p.sd[1] + j);
  }
  // tokens past the end: w = 1, the rest zeros
#pragma unroll 1
  for (int x = threadIdx.x; x < (L - n) * RB; x += NT) {
    const int t = n + x / RB, i = x % RB;
    rs[t * RB + i] = 0.f;
    ks[t * RB + i] = 0.f;
    ws[t * RB + i] = 1.f;
  }
#pragma unroll 1
  for (int x = threadIdx.x; x < (L - n) * HD; x += NT) {
    const int t = n + x / HD, j = x % HD;
    vs[t * HP + j] = 0.f;
    ds[t * HP + j] = 0.f;
  }
}

template <class K>
__global__ void __launch_bounds__(K::NT, K::kMinBlocks)
    wkv6_pair_kernel(const __grid_constant__ BParams p) {
  constexpr int HD = K::HD, RB = K::RB, NT = K::NT, L = K::L, HP = K::HP;
  constexpr int kRowBlocks = HD / RB;
  extern __shared__ float4 smem4[];
  float* rs = reinterpret_cast<float*>(smem4);  // (L, RB)
  float* ks = rs + L * RB;
  float* ws = ks + L * RB;
  float* vs = ws + L * RB;  // (L, HP)
  float* ds = vs + L * HP;
  float* mt = ds + L * HP;  // (L, L)
  float* as = vs;           // (L, RB) each, once v and dy are done with
  float* bs = as + L * RB;
  float* us = ws;
  const int blk = blockIdx.x;
  const int i0 = blk % kRowBlocks * RB;
  const int c = blk / kRowBlocks % p.nck;
  const int bh = blk / kRowBlocks / p.nck;
  const int b = bh / p.H, h = bh % p.H;
  const int tid = threadIdx.x;
  BHead a;
  a.r = p.r + b * p.sr[0] + h * p.sr[2];
  a.k = p.k + b * p.sk[0] + h * p.sk[2];
  a.v = p.v + b * p.sv[0] + h * p.sv[2];
  a.w = p.w + b * p.sw[0] + h * p.sw[2];
  a.dy = p.dy + b * p.sd[0] + h * p.sd[2];
  const long long ta = (long long)c * L;
  const int n = (int)min((long long)L, (long long)p.S - ta);
  if (p.vec)
    stage_pair<K, 4>(p, a, rs, ks, ws, vs, ds, ta, n, i0);
  else
    stage_pair<K, 1>(p, a, rs, ks, ws, vs, ds, ta, n, i0);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  // M[x][y] = dy_x . v_y: thread (x, half) the YS columns y of its half
  // (both triangles; the walk reads x >= y), into Mt[y][x].
  {
    constexpr int YS = L / (NT / 32);
    const int x = tid % 32, y0 = tid / 32 * YS;
    float acc[YS];
#pragma unroll
    for (int y = 0; y < YS; ++y) acc[y] = 0.f;
    const float4* d4 = reinterpret_cast<const float4*>(ds + x * HP);
#pragma unroll 2
    for (int q = 0; q < HD / 4; ++q) {
      const float4 dd = d4[q];
#pragma unroll
      for (int y = 0; y < YS; ++y) {
        const float4 vv =
            reinterpret_cast<const float4*>(vs + (y0 + y) * HP)[q];
        acc[y] = fmaf(dd.x, vv.x, acc[y]);
        acc[y] = fmaf(dd.y, vv.y, acc[y]);
        acc[y] = fmaf(dd.z, vv.z, acc[y]);
        acc[y] = fmaf(dd.w, vv.w, acc[y]);
      }
    }
#pragma unroll
    for (int y = 0; y < YS; ++y) mt[(y0 + y) * L + x] = acc[y];
  }

  // A_t = dy_t . S_a[i], B_t = v_t . G_b[i] and Z = G_b[i] . S_a[i] for
  // this thread's row, from the checkpoint rows (one 16-byte chunk ahead)
  const int i = i0 + tid;
  const bool row = tid < RB;
  float A[L], B[L], Z = 0.f;
#pragma unroll
  for (int t = 0; t < L; ++t) A[t] = B[t] = 0.f;
  if (row) {
    const long long off = (((long long)bh * p.nck + c) * HD + i) * HD;
    const float4* sa = reinterpret_cast<const float4*>(p.ckpt + off);
    const float4* gb = reinterpret_cast<const float4*>(p.gck + off);
    float4 s_next = sa[0], g_next = gb[0];
#pragma unroll 1
    for (int q = 0; q < HD / 4; ++q) {
      const float4 s4 = s_next, g4 = g_next;
      if (q + 1 < HD / 4) s_next = sa[q + 1], g_next = gb[q + 1];
      Z = fmaf(g4.x, s4.x, Z);
      Z = fmaf(g4.y, s4.y, Z);
      Z = fmaf(g4.z, s4.z, Z);
      Z = fmaf(g4.w, s4.w, Z);
#pragma unroll
      for (int t = 0; t < L; ++t) {
        const float4 dd = reinterpret_cast<const float4*>(ds + t * HP)[q];
        const float4 vv = reinterpret_cast<const float4*>(vs + t * HP)[q];
        A[t] = fmaf(s4.x, dd.x, A[t]);
        A[t] = fmaf(s4.y, dd.y, A[t]);
        A[t] = fmaf(s4.z, dd.z, A[t]);
        A[t] = fmaf(s4.w, dd.w, A[t]);
        B[t] = fmaf(g4.x, vv.x, B[t]);
        B[t] = fmaf(g4.y, vv.y, B[t]);
        B[t] = fmaf(g4.z, vv.z, B[t]);
        B[t] = fmaf(g4.w, vv.w, B[t]);
      }
    }
  }
  __syncthreads();  // v and dy are done with: A and B go over them
  if (!row) return;
  float r[L], w[L];
#pragma unroll
  for (int t = 0; t < L; ++t) {
    r[t] = rs[t * RB + tid];
    w[t] = ws[t * RB + tid];
    as[t * RB + tid] = A[t];
    bs[t * RB + tid] = B[t];
  }
  {  // U, walked back: U_{t-1} = w_t U_t + r_t A_t
    float U = 0.f;
    us[(L - 1) * RB + tid] = U;
#pragma unroll
    for (int t = L - 1; t > 0; --t) {
      U = fmaf(w[t], U, r[t] * A[t]);
      us[(t - 1) * RB + tid] = U;
    }
  }

  // The walk forwards: P, Q and E carried, the pair sums over s > t.
  const float ui = p.u[(long long)h * HD + i];
  const long long orow = b * p.so[0] + h * p.so[2] + i;
  float P[L];
#pragma unroll
  for (int t = 0; t < L; ++t) P[t] = 0.f;
  float E = 1.f, Q = 0.f, du = 0.f;
#pragma unroll
  for (int t = 0; t < L; ++t) {
    const float kt = ks[t * RB + tid], At = as[t * RB + tid];
    const float Bt = bs[t * RB + tid], Ut = us[t * RB + tid];
    const float ct = mt[t * L + t];
    // the pair sums, even and odd s apart: two chains each
    float T = 1.f, dkp[2] = {0.f, 0.f}, dw4[2] = {0.f, 0.f};
#pragma unroll
    for (int q = (t + 1) / 4; q < L / 4; ++q) {
      const float4 m4 = reinterpret_cast<const float4*>(mt + t * L)[q];
      const float mv[4] = {m4.x, m4.y, m4.z, m4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = 4 * q + e;
        if (s > t) {
          const float Y = T * r[s];
          dkp[s % 2] = fmaf(Y, mv[e], dkp[s % 2]);
          dw4[s % 2] = fmaf(Y, P[s], dw4[s % 2]);
          P[s] = fmaf(w[t], P[s], kt * mv[e]);
          T *= w[s];
        }
      }
    }
    // into this thread's slots of k, r and U, read for the last time
    // above: no branch in the walk (tokens past n add 0 to du)
    ks[t * RB + tid] = fmaf(ui * kt, ct, fmaf(E, At, P[t]));
    rs[t * RB + tid] = fmaf(ui * r[t], ct, fmaf(T, Bt, dkp[0] + dkp[1]));
    us[t * RB + tid] = fmaf(T, fmaf(E, Z, Q), fmaf(E, Ut, dw4[0] + dw4[1]));
    du = fmaf(r[t] * kt, ct, du);
    Q = fmaf(w[t], Q, kt * Bt);
    E *= w[t];
  }
#pragma unroll 1
  for (int t = 0; t < n; ++t) {
    const long long o = (ta + t) * p.so[1] + orow;
    p.dr[o] = ks[t * RB + tid];
    p.dk[o] = rs[t * RB + tid];
    p.dw[o] = us[t * RB + tid];
  }
  p.du_part[((long long)bh * p.nck + c) * HD + i] = du;
}

template <class K>
cudaError_t launch_pair(const BParams& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * K::kFloats;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_pair_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * p.H * p.nck * (K::HD / K::RB);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  wkv6_pair_kernel<K><<<(unsigned)blocks, K::NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// du[h, i] = the sum of du_part (B, H, nck, hd) over b and the spans, in
// a fixed order: warp x of 32 sums every 32nd (b, span) pair from x, then
// warp 0 sums the 32.  Grid (H, ceil(hd / 32)); lane i of a warp is row
// 32 y + i.
__global__ void __launch_bounds__(1024)
    wkv6_du_kernel(const float* __restrict__ part, float* __restrict__ du,
                   int B, int H, int nck, int hd) {
  __shared__ float red[32][33];
  const int h = blockIdx.x, lane = threadIdx.x % 32, wp = threadIdx.x / 32;
  const int i = blockIdx.y * 32 + lane;
  float s = 0.f;
  if (i < hd)
    for (int x = wp; x < B * nck; x += 32)
      s += part[(((long long)(x / nck) * H + h) * nck + x % nck) * hd + i];
  red[wp][lane] = s;
  __syncthreads();
  if (wp == 0 && i < hd) {
    float t = 0.f;
#pragma unroll
    for (int x = 0; x < 32; ++x) t += red[x][lane];
    du[(long long)h * hd + i] = t;
  }
}

}  // namespace

extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0,
                        void* y, void* s_final, void* ckpt, int B, int S,
                        int H, int hd,
                        long long r_sb, long long r_ss, long long r_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        long long w_sb, long long w_ss, long long w_sh,
                        long long y_sb, long long y_ss, long long y_sh,
                        int chunk, int vec, void* stream) {
  if (B < 1 || S < 1 || H < 1 || chunk < 1 || chunk > 128)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.r = static_cast<const float*>(r);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.w = static_cast<const float*>(w);
  p.u = static_cast<const float*>(u);
  p.s0 = static_cast<const float*>(s0);
  p.y = static_cast<float*>(y);
  p.s_final = static_cast<float*>(s_final);
  p.ckpt = static_cast<float*>(ckpt);
  const long long strides[5][3] = {{r_sb, r_ss, r_sh}, {k_sb, k_ss, k_sh},
                                   {v_sb, v_ss, v_sh}, {w_sb, w_ss, w_sh},
                                   {y_sb, y_ss, y_sh}};
  long long* dst[5] = {p.sr, p.sk, p.sv, p.sw, p.sy};
  for (int a = 0; a < 5; ++a)
    for (int d = 0; d < 3; ++d) dst[a][d] = strides[a][d];
  // y is stored up to 16 bytes at a time; r, k, v, w are copied 16 bytes at
  // a time only where the caller says they allow it, and that is checked.
  const void* ins[4] = {r, k, v, w};
  if (!aligned16(y, p.sy, B, S, H)) return (int)cudaErrorMisalignedAddress;
  for (int a = 0; a < 4 && vec; ++a)
    if (!aligned16(ins[a], strides[a], B, S, H))
      return (int)cudaErrorMisalignedAddress;
  p.H = H;
  p.S = S;
  p.nck = (S + kCkptEvery - 1) / kCkptEvery;
  p.chunk = chunk;
  p.vec = vec ? 1 : 0;
  p.phase = 0;
  p.ck_back = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return (int)launch_fwd<Pick<16>::T>(p, B, st);
    case 32: return (int)launch_fwd<Pick<32>::T>(p, B, st);
    case 64: return (int)launch_fwd<Pick<64>::T>(p, B, st);
    case 128: return (int)launch_fwd<Pick<128>::T>(p, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// strides: (b, s, h) element strides of r, k, v, w, dy, dr (dk and dw
// alike) and dv, 21 in all.  ckpt: the forward's checkpoints of the same
// inputs; ds_final may be null (zeros).  Scratch, nck = ceil(S /
// kCkptEvery): gck (B, H, nck, hd, hd), where the reverse pass leaves the
// gradient of the state after each span, and du_part (B, H, nck, hd).
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* dy,
                        const void* ckpt, const void* ds_final, void* dr,
                        void* dk, void* dv, void* dw, void* du, void* ds0,
                        void* gck, void* du_part, int B, int S, int H, int hd,
                        const long long* strides, int chunk, int vec,
                        void* stream) {
  if (B < 1 || S < 1 || H < 1 || chunk < 1 || chunk > 128)
    return (int)cudaErrorInvalidValue;
  if (hd != 16 && hd != 32 && hd != 64 && hd != 128)
    return (int)cudaErrorInvalidValue;
  const void* ins[5] = {r, k, v, w, dy};
  for (int a = 0; a < 5 && vec; ++a)
    if (!aligned16(ins[a], strides + 3 * a, B, S, H))
      return (int)cudaErrorMisalignedAddress;
  if (!aligned16(dv, strides + 18, B, S, H) ||
      reinterpret_cast<uintptr_t>(ckpt) % 16 ||
      reinterpret_cast<uintptr_t>(gck) % 16)
    return (int)cudaErrorMisalignedAddress;
  const int nck = (S + kCkptEvery - 1) / kCkptEvery;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;

  // 1. dv, ds0 and the gradient after every span: the checkpointing
  // forward on the sequence reversed, with r -> k, k -> r, v -> dy, s0 ->
  // ds_final.  Its state is G, its y dv, its final state ds0.  Each
  // pointer starts at token S - 1 and walks back; reversed token t' is
  // token S - 1 - t', so the state before it is G after that token, the
  // end of a span where (S - t') % kCkptEvery == 0 (phase) or t' == 0,
  // stored from the last slot down (ck_back): gck[c] is G after span c.
  const long long back = S - 1;
  const long long* sk = strides + 3;
  Params q;
  q.r = static_cast<const float*>(k) + back * sk[1];
  q.k = static_cast<const float*>(r) + back * strides[1];
  q.v = static_cast<const float*>(dy) + back * strides[13];
  q.w = static_cast<const float*>(w) + back * strides[10];
  q.u = static_cast<const float*>(u);
  q.s0 = static_cast<const float*>(ds_final);
  q.y = static_cast<float*>(dv) + back * strides[19];
  q.s_final = static_cast<float*>(ds0);
  q.ckpt = static_cast<float*>(gck);
  const long long* from[5] = {strides + 3, strides, strides + 12,
                              strides + 9, strides + 18};  // k r dy w dv
  long long* to[5] = {q.sr, q.sk, q.sv, q.sw, q.sy};
  for (int a = 0; a < 5; ++a) {
    to[a][0] = from[a][0];
    to[a][1] = -from[a][1];
    to[a][2] = from[a][2];
  }
  q.H = H;
  q.S = S;
  q.nck = nck;
  q.chunk = chunk;
  q.vec = vec ? 1 : 0;
  q.phase = (kCkptEvery - S % kCkptEvery) % kCkptEvery;
  q.ck_back = 1;
  switch (hd) {
    case 16:
      err = launch<Pick<16>::T>(wkv6_rev_kernel<Pick<16>::T>, q, B, st);
      break;
    case 32:
      err = launch<Pick<32>::T>(wkv6_rev_kernel<Pick<32>::T>, q, B, st);
      break;
    case 64:
      err = launch<Pick<64>::T>(wkv6_rev_kernel<Pick<64>::T>, q, B, st);
      break;
    default:
      err = launch<Pick<128>::T>(wkv6_rev_kernel<Pick<128>::T>, q, B, st);
      break;
  }
  if (err != cudaSuccess) return (int)err;

  // 2. dr, dk, dw and du by span, every span at once.
  BParams p;
  p.r = static_cast<const float*>(r);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.w = static_cast<const float*>(w);
  p.dy = static_cast<const float*>(dy);
  p.u = static_cast<const float*>(u);
  p.ckpt = static_cast<const float*>(ckpt);
  p.gck = static_cast<const float*>(gck);
  p.dr = static_cast<float*>(dr);
  p.dk = static_cast<float*>(dk);
  p.dw = static_cast<float*>(dw);
  p.du_part = static_cast<float*>(du_part);
  long long* dst[6] = {p.sr, p.sk, p.sv, p.sw, p.sd, p.so};
  for (int a = 0; a < 6; ++a)
    for (int d = 0; d < 3; ++d) dst[a][d] = strides[3 * a + d];
  p.H = H;
  p.S = S;
  p.nck = nck;
  p.vec = vec ? 1 : 0;
  switch (hd) {
    case 16: err = launch_pair<PPick<16>::T>(p, B, st); break;
    case 32: err = launch_pair<PPick<32>::T>(p, B, st); break;
    case 64: err = launch_pair<PPick<64>::T>(p, B, st); break;
    default: err = launch_pair<PPick<128>::T>(p, B, st); break;
  }
  if (err != cudaSuccess) return (int)err;

  // 3. du over b and the spans.
  wkv6_du_kernel<<<dim3(H, (hd + 31) / 32), 1024, 0, st>>>(
      p.du_part, static_cast<float*>(du), B, H, nck, hd);
  return (int)cudaGetLastError();
}
