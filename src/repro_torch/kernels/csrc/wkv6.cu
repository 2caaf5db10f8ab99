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
//    (kCkptEvery) to (B, H, ceil(S / 32), hd, hd), each thread its own
//    elements straight from registers.  That is a template flag: serving
//    passes none and runs the kernel built without it.
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
// division into O(0.1) errors.  Both walks here multiply by w <= 1 only.
// Three launches, no atomics (two calls give equal bits):
//  * wkv6_bwd_kernel: rows are independent in dr, dk, dw (sums over j), so
//    a block owns RB rows of one head, all columns; NJ neighbouring lanes
//    share a row.  Spans of kCkptEvery tokens are taken last to first,
//    staged (r, k, w rows, v, dy) through a two-stage cp.async ring.  In a
//    span, pass 1 runs the state on from the span's checkpoint and keeps
//    it at every CI-th token in the thread's own shared-memory slots; pass
//    2 takes those sub-spans last to first, recomputes the state before
//    each of its CI tokens into registers, and walks them backwards with G
//    in registers.  Each token leaves four sums over the lane's columns
//    (dy.S, G.v, G.S, dy.v); one transposing butterfly over the CI lanes
//    (after adding lanes CI, 2 CI, ... apart where NJ > CI) leaves lane g
//    with token g's whole sums, and it stores dr, dk, dw.  du is summed
//    per (b, h, row) over the tokens and written to a (B, H, hd) scratch.
//  * dv and ds0: dv_t = k_t (G_t + diag(u) r_t^T dy_t) and G_{t-1} =
//    diag(w_t) G_t + r_t^T dy_t are the forward recurrence with r and k
//    swapped, v -> dy and s0 -> ds_final, run from the last token to the
//    first: the forward kernel itself, on pointers that start at token
//    S - 1 with negated token strides.  Its y is dv, its final state ds0.
//  * wkv6_du_kernel sums du over b, in order.
// Bounds at the training step's shape (B=4, S=2048, H=40, hd=64, fp32) on
// an H100 SXM:
//  * bytes: r, k, v, w and dy read, dr, dk, dv and dw written, 9 x 83.9 MB,
//    plus the 168 MB of checkpoints read: ~0.92 GB, 0.28 ms at 3.35 TB/s;
//  * instructions: at least 8 fp32 instructions per state element per
//    token (2 for the state's recompute, 2 for the G update, one FMA each
//    for dr, dw, dk, dv), 336 M warp instructions, ~0.36 ms at the
//    forward's rate.  The bound is ~0.36 ms, instructions.  As FLOP (3
//    for the recompute, 3 for G, 2 each for dr, dk, dv, dw: 14 B S H hd^2
//    = 18.8 GFLOP) it is 0.28 ms at 67 TFLOP/s fp32, as chip_smoke.py
//    counts it.
// This first design spends more: the row walk 10 per element and token
// (the state is recomputed twice, once for the sub-span checkpoints, once
// into registers) plus the butterflies, and the dv pass the forward's 4,
// on inputs it reads again.  Tensor cores and the chunked form are later
// work.

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
  int nck;    // checkpoints a head: ceil(S / kCkptEvery)
  int chunk;  // tokens per stage
  int vec;    // 1: 16-byte copies, 0: 4-byte copies
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

// Walks tokens t0 .. t0 + m - 1 (m <= G; kFull: m == G) of one stage whose
// first token is `base` in the sequence, and stores their y.
// Thread (g, cg) holds rows 4 (g + G q) + e, q < ROWS / 4, e < 4, of
// columns cg COLS + c, c < COLS.  Each token's partial sums over the
// thread's rows stay in registers until the group ends; then one
// transposing butterfly over the G lanes sums them, leaving lane g with
// token t0 + g: G - 1 shuffles per column per group instead of
// log2(G) per column per token, and no shuffle on the walk's chain.
template <class K, bool kFull, bool kCkpt>
__device__ __forceinline__ void walk_group(const Params& p, const Head& a,
                                           long long base, int j0,
                                           const float* stage, int C, int t0,
                                           int m, int g, int cg,
                                           const float (&ur)[K::ROWS],
                                           float (&st)[K::COLS][K::ROWS]) {
  constexpr int HD = K::HD, VT = K::VT, G = K::G;
  constexpr int ROWS = K::ROWS, COLS = K::COLS;
  const float* rs = stage;
  const float* ks = rs + C * HD;
  const float* ws = ks + C * HD;
  const float* vs = ws + C * HD;
  // the group's first token, counted from the last checkpoint
  const int ck0 = kCkpt ? (int)((base + t0) % kCkptEvery) : 0;
  float part[COLS][G];
#pragma unroll
  for (int tt = 0; tt < G; ++tt) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) part[c][tt] = 0.f;
    if (kFull || tt < m) {
      const int t = t0 + tt;
      if constexpr (kCkpt) {
        // the state before a token of a multiple of kCkptEvery: each
        // thread writes its rows' COLS columns straight from registers
        if ((ck0 + tt) % kCkptEvery == 0) {
          float* ck = a.ck + (base + t) / kCkptEvery * (HD * HD) +
                      cg * COLS;
#pragma unroll
          for (int q = 0; q < ROWS / 4; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float row[COLS];
#pragma unroll
              for (int c = 0; c < COLS; ++c) row[c] = st[c][4 * q + e];
              store_cols<COLS>(ck + (4 * (g + G * q) + e) * HD, row);
            }
        }
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
}

// Walks the n tokens of one stage, G at a time.
template <class K, bool kCkpt>
__device__ __forceinline__ void walk(const Params& p, const Head& a,
                                     long long base, int j0,
                                     const float* stage, int C, int n, int g,
                                     int cg, const float (&ur)[K::ROWS],
                                     float (&st)[K::COLS][K::ROWS]) {
  int t0 = 0;
#pragma unroll 1
  for (; t0 + K::G <= n; t0 += K::G)
    walk_group<K, true, kCkpt>(p, a, base, j0, stage, C, t0, K::G, g, cg, ur,
                               st);
  if (t0 < n)
    walk_group<K, false, kCkpt>(p, a, base, j0, stage, C, t0, n - t0, g, cg,
                                ur, st);
}

// kCkpt: also write the state before every kCkptEvery-th token to p.ckpt
// (the training forward); serving builds the kernel without it.
template <class K, bool kCkpt>
__global__ void __launch_bounds__(K::NT, K::kMinBlocks)
    wkv6_kernel(const __grid_constant__ Params p) {
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
    walk<K, kCkpt>(p, a, (long long)ci * C, j0,
                   ring + (ci % kStages) * stage_floats, C,
                   min(C, S - ci * C), g, cg, ur, st);
  }

  // The final state leaves through the tile, whole rows at a time.
#pragma unroll
  for (int c = 0; c < COLS; ++c)
#pragma unroll
    for (int q = 0; q < ROWS / 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tile[(cg * COLS + c) * (HD + 1) + 4 * (g + G * q) + e] =
            st[c][4 * q + e];
  __syncthreads();
  float* sf = p.s_final + sbase + j0;
  for (int x = tid; x < HD * VT; x += NT) {
    const int i = x / VT, jj = x % VT;
    sf[(long long)i * HD + jj] = tile[jj * (HD + 1) + i];
  }
}

template <class K, bool kCkpt>
cudaError_t launch(Params p, int B, cudaStream_t stream) {
  const size_t token_bytes = sizeof(float) * K::kTokenFloats;
  const size_t tile_bytes = sizeof(float) * K::kTileFloats;
  const int fit = (int)((kSmemMax - tile_bytes) / (kStages * token_bytes));
  p.chunk = std::min(std::min(p.chunk, p.S), fit);
  const size_t smem = tile_bytes + kStages * p.chunk * token_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<K, kCkpt>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * p.H, K::HD / K::VT);
  wkv6_kernel<K, kCkpt><<<grid, K::NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <class K>
cudaError_t launch_fwd(const Params& p, int B, cudaStream_t stream) {
  return p.ckpt ? launch<K, true>(p, B, stream)
                : launch<K, false>(p, B, stream);
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

// ---------------------------------------------------------------------------
// The backward: dr, dk, dw and du by the row walk below, dv and ds0 by the
// forward kernel walked back in time (see the header).
// ---------------------------------------------------------------------------

constexpr int kBwdStages = 2;

// NJ lanes share one state row, each holding E = HD / NJ of its columns
// (lane l: columns 4 (l + NJ q) + e, e < 4); RB rows a block; CI tokens a
// sub-span, which is also the butterfly's group; MINB blocks an SM must
// hold (launch bounds).
template <int HD_, int NJ_, int RB_, int CI_, int MINB_>
struct BCfg {
  static constexpr int HD = HD_, NJ = NJ_, RB = RB_, CI = CI_;
  static constexpr int E = HD / NJ;
  static constexpr int NT = RB * NJ;
  static constexpr int kMinBlocks = MINB_;
  static constexpr int kSub = kCkptEvery / CI;          // sub-spans a span
  static constexpr int kTokenFloats = 3 * RB + 2 * HD;  // r k w | v dy
  static constexpr int kStageFloats = kCkptEvery * kTokenFloats;
  static constexpr int kSubFloats = kSub * E * NT;
  static_assert(E % 4 == 0 && 32 % NJ == 0 && NJ % CI == 0, "lanes");
  static_assert(RB % 4 == 0 && HD % RB == 0 && NT % 32 == 0, "rows");
  static_assert(kCkptEvery % CI == 0, "sub-spans");
};

template <int HD>
struct BPick;
template <>
struct BPick<16> { using T = BCfg<16, 4, 16, 4, 4>; };
template <>
struct BPick<32> { using T = BCfg<32, 8, 16, 8, 4>; };
template <>
struct BPick<64> { using T = BCfg<64, 8, 16, 8, 3>; };
template <>
struct BPick<128> { using T = BCfg<128, 16, 8, 8, 2>; };

struct BParams {
  const float *r, *k, *v, *w, *dy;
  const float* u;         // (H, hd), contiguous
  const float* ckpt;      // (B, H, nck, hd, hd), contiguous
  const float* ds_final;  // (B, H, hd, hd), contiguous, or null for zeros
  float *dr, *dk, *dw;    // (B, S, H, hd), strides so
  float* du_part;         // (B, H, hd): du summed over the tokens
  long long sr[3], sk[3], sv[3], sw[3], sd[3], so[3];
  int H, S, nck;
  int vec;  // 1: 16-byte copies, 0: 4-byte copies
};

struct BHead {
  const float *r, *k, *v, *w, *dy;
};

// Span layout, kCkptEvery tokens: r, k, w (kCkptEvery, RB) for the block's
// rows | v, dy (kCkptEvery, HD).
template <class K, int W>
__device__ __forceinline__ void load_span(const BParams& p, const BHead& a,
                                          float* stage, long long t0, int n,
                                          int i0) {
  float* rs = stage;
  float* ks = rs + kCkptEvery * K::RB;
  float* ws = ks + kCkptEvery * K::RB;
  float* vs = ws + kCkptEvery * K::RB;
  float* ds = vs + kCkptEvery * K::HD;
  constexpr int QR = K::RB / W;
#pragma unroll 1
  for (int x = threadIdx.x; x < n * QR; x += K::NT) {
    const int t = x / QR, i = i0 + (x % QR) * W;
    const long long tt = t0 + t;
    cp_async<W>(rs + t * K::RB + i - i0, a.r + tt * p.sr[1] + i);
    cp_async<W>(ks + t * K::RB + i - i0, a.k + tt * p.sk[1] + i);
    cp_async<W>(ws + t * K::RB + i - i0, a.w + tt * p.sw[1] + i);
  }
  constexpr int QV = K::HD / W;
#pragma unroll 1
  for (int x = threadIdx.x; x < n * QV; x += K::NT) {
    const int t = x / QV, j = (x % QV) * W;
    const long long tt = t0 + t;
    cp_async<W>(vs + t * K::HD + j, a.v + tt * p.sv[1] + j);
    cp_async<W>(ds + t * K::HD + j, a.dy + tt * p.sd[1] + j);
  }
}

template <class K>
__device__ __forceinline__ void load_span(const BParams& p, const BHead& a,
                                          float* stage, long long t0, int n,
                                          int i0) {
  if (p.vec)
    load_span<K, 4>(p, a, stage, t0, n, i0);
  else
    load_span<K, 1>(p, a, stage, t0, n, i0);
}

// Lane l's E columns of a row (shared or global memory, 16-byte aligned).
template <class K>
__device__ __forceinline__ void load_row(const float* src, int l,
                                         float (&d)[K::E]) {
#pragma unroll
  for (int q = 0; q < K::E / 4; ++q) {
    const float4 x =
        *reinterpret_cast<const float4*>(src + 4 * (l + K::NJ * q));
    d[4 * q] = x.x, d[4 * q + 1] = x.y, d[4 * q + 2] = x.z, d[4 * q + 3] = x.w;
  }
}

// The state row through token t of the stage: S <- w S + k v.
template <class K>
__device__ __forceinline__ void advance(float (&st)[K::E], const float* ks,
                                        const float* ws, const float* vs,
                                        int t, int ri, int l) {
  const float kk = ks[t * K::RB + ri], ww = ws[t * K::RB + ri];
  float vj[K::E];
  load_row<K>(vs + t * K::HD, l, vj);
#pragma unroll
  for (int e = 0; e < K::E; ++e) st[e] = fmaf(ww, st[e], kk * vj[e]);
}

// One span of n tokens (the first at ta in the sequence), walked back from
// its end with G, the gradient of the state after the span, in registers.
// Pass 1 runs the state from the span's checkpoint (row i at `ck`) and
// keeps it at each sub-span's start in this thread's slots of `subck`.
// Pass 2 takes the sub-spans last to first: it recomputes the state before
// each of the sub-span's CI tokens into registers (`hist`), then walks
// them backwards, leaving each token's four sums over this lane's columns
// (dy.S, G.v, G.S, dy.v) in `part`; one reduction across the row's lanes
// leaves lane g with token g's, which it finishes and stores.
template <class K>
__device__ __forceinline__ void walk_span(const BParams& p, float* dr,
                                          float* dk, float* dw,
                                          const float* stage, float* subck,
                                          const float* ck, long long ta,
                                          int n, int ri, int l, float ui,
                                          float (&G)[K::E], float& du) {
  constexpr int HD = K::HD, NJ = K::NJ, RB = K::RB, CI = K::CI, E = K::E;
  constexpr int NT = K::NT;
  const float* rs = stage;
  const float* ks = rs + kCkptEvery * RB;
  const float* ws = ks + kCkptEvery * RB;
  const float* vs = ws + kCkptEvery * RB;
  const float* ds = vs + kCkptEvery * HD;
  const int tid = threadIdx.x;
  float st[E];
  load_row<K>(ck, l, st);
  const int nsub = (n + CI - 1) / CI;
#pragma unroll 1
  for (int m = 0; m < nsub; ++m) {
#pragma unroll
    for (int e = 0; e < E; ++e) subck[(m * E + e) * NT + tid] = st[e];
    if (m + 1 < nsub) {  // every token of this sub-span is in the span
#pragma unroll
      for (int tt = 0; tt < CI; ++tt)
        advance<K>(st, ks, ws, vs, m * CI + tt, ri, l);
    }
  }
#pragma unroll 1
  for (int m = nsub - 1; m >= 0; --m) {
    const int t0 = m * CI, mn = min(CI, n - t0);
    float hist[CI][E];
#pragma unroll
    for (int e = 0; e < E; ++e) st[e] = subck[(m * E + e) * NT + tid];
#pragma unroll
    for (int tt = 0; tt < CI; ++tt) {
#pragma unroll
      for (int e = 0; e < E; ++e) hist[tt][e] = st[e];
      if (tt + 1 < mn) advance<K>(st, ks, ws, vs, t0 + tt, ri, l);
    }
    float part[4][CI];
#pragma unroll
    for (int tt = CI - 1; tt >= 0; --tt) {
      float a_dr = 0.f, a_dk = 0.f, a_dw = 0.f, a_c = 0.f;
      if (tt < mn) {
        const int t = t0 + tt;
        const float rr = rs[t * RB + ri], ww = ws[t * RB + ri];
        float vj[E], dj[E];
        load_row<K>(vs + t * HD, l, vj);
        load_row<K>(ds + t * HD, l, dj);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          a_dr = fmaf(dj[e], hist[tt][e], a_dr);
          a_dk = fmaf(G[e], vj[e], a_dk);
          a_dw = fmaf(G[e], hist[tt][e], a_dw);
          a_c = fmaf(dj[e], vj[e], a_c);
          G[e] = fmaf(ww, G[e], rr * dj[e]);
        }
      }
      part[0][tt] = a_dr;
      part[1][tt] = a_dk;
      part[2][tt] = a_dw;
      part[3][tt] = a_c;
    }
    // lanes CI, 2 CI, ... apart hold the same tokens over other columns;
    // then the transposing butterfly over the CI lanes below
#pragma unroll
    for (int o = NJ / 2; o >= CI; o /= 2)
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int tt = 0; tt < CI; ++tt)
          part[x][tt] += __shfl_xor_sync(0xffffffffu, part[x][tt], o);
    butterfly<CI / 2>(part, l % CI);
    if (l < mn) {  // lane l < CI holds token t0 + l
      const int t = t0 + l;
      const float rr = rs[t * RB + ri], kk = ks[t * RB + ri];
      const float c = part[3][0];
      const long long o = (ta + t) * p.so[1];
      dr[o] = fmaf(ui * kk, c, part[0][0]);
      dk[o] = fmaf(ui * rr, c, part[1][0]);
      dw[o] = part[2][0];
      du = fmaf(rr * kk, c, du);
    }
  }
}

template <class K>
__global__ void __launch_bounds__(K::NT, K::kMinBlocks)
    wkv6_bwd_kernel(const __grid_constant__ BParams p) {
  constexpr int HD = K::HD, NJ = K::NJ, RB = K::RB, E = K::E;
  extern __shared__ float4 smem4[];
  float* subck = reinterpret_cast<float*>(smem4);  // (kSub, E, NT)
  float* ring = subck + K::kSubFloats;
  const int S = p.S, nck = p.nck;
  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int i0 = blockIdx.y * RB;
  const int tid = threadIdx.x, l = tid % NJ, ri = tid / NJ, i = i0 + ri;
  BHead a;
  a.r = p.r + b * p.sr[0] + h * p.sr[2];
  a.k = p.k + b * p.sk[0] + h * p.sk[2];
  a.v = p.v + b * p.sv[0] + h * p.sv[2];
  a.w = p.w + b * p.sw[0] + h * p.sw[2];
  a.dy = p.dy + b * p.sd[0] + h * p.sd[2];
  const long long orow = b * p.so[0] + h * p.so[2] + i;
  float* dr = p.dr + orow;
  float* dk = p.dk + orow;
  float* dw = p.dw + orow;
  const float ui = p.u[(long long)h * HD + i];
  const long long sbase = (long long)bh * HD * HD;
  float G[E];
  if (p.ds_final) {
    load_row<K>(p.ds_final + sbase + (long long)i * HD, l, G);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) G[e] = 0.f;
  }
  float du = 0.f;
  const float* ck = p.ckpt + sbase * nck + (long long)i * HD;

  // Spans last to first, through a ring of kBwdStages stages: span c - 1
  // loads while span c is walked.
  const long long last = (long long)(nck - 1) * kCkptEvery;
  load_span<K>(p, a, ring, last, (int)(S - last), i0);
  cp_commit();
#pragma unroll 1
  for (int x = 0; x < nck; ++x) {
    const int c = nck - 1 - x;
    cp_wait<0>();     // span c has landed (this thread's copies)
    __syncthreads();  // ... everyone's; span c + 1 is walked
    if (c > 0)
      load_span<K>(p, a, ring + ((x + 1) % kBwdStages) * K::kStageFloats,
                   (long long)(c - 1) * kCkptEvery, kCkptEvery, i0);
    cp_commit();
    const long long ta = (long long)c * kCkptEvery;
    walk_span<K>(p, dr, dk, dw, ring + (x % kBwdStages) * K::kStageFloats,
                 subck, ck + ta / kCkptEvery * (HD * HD), ta,
                 (int)min((long long)kCkptEvery, S - ta), ri, l, ui, G, du);
  }
#pragma unroll
  for (int o = NJ / 2; o > 0; o /= 2)
    du += __shfl_xor_sync(0xffffffffu, du, o);
  if (l == 0) p.du_part[(long long)bh * HD + i] = du;
}

// du = sum over b of du_part, in order.
__global__ void wkv6_du_kernel(const float* __restrict__ part,
                               float* __restrict__ du, int B, int n) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= n) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += part[(long long)b * n + x];
  du[x] = s;
}

template <class K>
cudaError_t launch_bwd(const BParams& p, int B, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (K::kSubFloats + kBwdStages * K::kStageFloats);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * p.H, K::HD / K::RB);
  wkv6_bwd_kernel<K><<<grid, K::NT, smem, stream>>>(p);
  return cudaGetLastError();
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
// inputs; ds_final may be null (zeros).  du_part is (B, H, hd) scratch.
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* dy,
                        const void* ckpt, const void* ds_final, void* dr,
                        void* dk, void* dv, void* dw, void* du, void* ds0,
                        void* du_part, int B, int S, int H, int hd,
                        const long long* strides, int chunk, int vec,
                        void* stream) {
  if (B < 1 || S < 1 || H < 1 || chunk < 1 || chunk > 128)
    return (int)cudaErrorInvalidValue;
  const void* ins[5] = {r, k, v, w, dy};
  for (int a = 0; a < 5 && vec; ++a)
    if (!aligned16(ins[a], strides + 3 * a, B, S, H))
      return (int)cudaErrorMisalignedAddress;
  if (!aligned16(dv, strides + 18, B, S, H))
    return (int)cudaErrorMisalignedAddress;
  BParams p;
  p.r = static_cast<const float*>(r);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.w = static_cast<const float*>(w);
  p.dy = static_cast<const float*>(dy);
  p.u = static_cast<const float*>(u);
  p.ckpt = static_cast<const float*>(ckpt);
  p.ds_final = static_cast<const float*>(ds_final);
  p.dr = static_cast<float*>(dr);
  p.dk = static_cast<float*>(dk);
  p.dw = static_cast<float*>(dw);
  p.du_part = static_cast<float*>(du_part);
  long long* dst[6] = {p.sr, p.sk, p.sv, p.sw, p.sd, p.so};
  for (int a = 0; a < 6; ++a)
    for (int d = 0; d < 3; ++d) dst[a][d] = strides[3 * a + d];
  p.H = H;
  p.S = S;
  p.nck = (S + kCkptEvery - 1) / kCkptEvery;
  p.vec = vec ? 1 : 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (hd) {
    case 16: err = launch_bwd<BPick<16>::T>(p, B, st); break;
    case 32: err = launch_bwd<BPick<32>::T>(p, B, st); break;
    case 64: err = launch_bwd<BPick<64>::T>(p, B, st); break;
    case 128: err = launch_bwd<BPick<128>::T>(p, B, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;

  // dv and ds0: the forward kernel on the sequence reversed, with r -> k,
  // k -> r, v -> dy, s0 -> ds_final: its state is G, its y is dv and its
  // final state ds0.  Each pointer starts at token S - 1 and walks back.
  const long long back = S - 1;
  Params q;
  q.r = p.k + back * p.sk[1];
  q.k = p.r + back * p.sr[1];
  q.v = p.dy + back * p.sd[1];
  q.w = p.w + back * p.sw[1];
  q.u = p.u;
  q.s0 = p.ds_final;
  q.y = static_cast<float*>(dv) + back * strides[19];
  q.s_final = static_cast<float*>(ds0);
  q.ckpt = nullptr;
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
  q.nck = 0;
  q.chunk = chunk;
  q.vec = p.vec;
  switch (hd) {
    case 16: err = launch<Pick<16>::T, false>(q, B, st); break;
    case 32: err = launch<Pick<32>::T, false>(q, B, st); break;
    case 64: err = launch<Pick<64>::T, false>(q, B, st); break;
    default: err = launch<Pick<128>::T, false>(q, B, st); break;
  }
  if (err != cudaSuccess) return (int)err;
  const int n = H * hd;
  wkv6_du_kernel<<<(n + 255) / 256, 256, 0, st>>>(p.du_part,
                                                  static_cast<float*>(du), B,
                                                  n);
  return (int)cudaGetLastError();
}
