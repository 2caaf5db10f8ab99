// The selective scan of Hymba's Mamba-style SSM for Hopper (sm_90a),
// forward and backward, bound to Python with ctypes.
//
// No TPU kernel: the JAX package runs the scan as a `lax.scan`
// (src/repro/models/blocks.py:286) and differentiates it with
// `jax.value_and_grad`.  These kernels replace that scan and its VJP.  Per
// batch row b, channel d (of d_inner) and state n (of N), with fp32 h:
//     decay_t = exp(dt_t[d] a[d, n]),   drive_t = dt_t[d] u_t[d] B_t[n],
//     h_t = decay_t h_{t-1} + drive_t,  y_t[d] = sum_n h_t[d, n] C_t[n].
// Inputs dt, u (B, S, D) fp32, B and C (B, S, N) fp32, a = -exp(a_log)
// (D, N) fp32 and h0 (B, D, N) fp32 or null (zeros), all contiguous.
// Outputs y (B, S, D) fp32 and h_last (B, D, N) fp32; decay and drive are
// formed in registers and never written (1.68 GB a layer at Hymba-1.5B's
// (4, 2048, 1600, 16)).  Rounding: decay = ex2.approx.ftz(dt (a log2 e)),
// a log2 e formed once a thread (one MUFU.EX2 and one multiply, no range
// reduction; the result flushes to 0 under strong decay), drive = (dt u) B,
// h = fma(decay, h, drive), y summed over n in four interleaved partial
// sums.  The plain loop rounds decay h and the sum apart, so the two differ
// by an ulp a step; chip_smoke's bars (1e-5 relative forward, 1e-4 x
// max(max |want|, 1) backward) hold at every SCAN_CASE with ex2.approx,
// strong decay included (y 1.1e-7 relative at the main shape).
//
// Layout: a thread holds several states of one (b, d) in registers: N /
// kFwdTpc = 8 in the forward's walks (two threads a channel at N = 16),
// kNs = 4 in the backward's.  dt and u are read once for those states, B_t
// and C_t arrive as 16-byte broadcasts, and y's sum over n is in-thread
// adds and one shuffle.  A block holds kChannels = 64 channels of one
// batch row and one chunk of `chunk` tokens (a runtime multiple of
// kCkptEvery; the wrapper's CHUNK is 96, the best of 64-256 at the main
// shape); the sequence's chunks run in parallel and are joined by the
// scan's linear carry.  The tokens of a chunk go in spans of kCkptEvery =
// 16: a span's channel rows (16 tokens x 64 channels, 256-byte rows) and
// its B / C rows are copied into one of two shared-memory stages by
// 16-byte cp.async (4-byte where D % 4 or a base breaks the alignment)
// while the block walks the span before (`Span`: a thread copies the same
// channels of every row it takes, one add from row to row).  Outputs a
// token at a time per channel (y; ddt, du) are staged a span at a time and
// stored as whole rows.
//
// Forward, three launches (one where the sequence is one chunk: decode,
// short spans):
//   `ssm_scan_chunk_kernel`  each chunk but the last walked from h = 0,
//       leaving hloc(c) (B, nC, D, N) and sdt(c) = sum of its dt (B, nC, D);
//   `ssm_scan_carry_kernel`  a thread a (b, d, n) walks the chunks:
//       h_in(c + 1) = exp(a sdt(c)) h_in(c) + hloc(c), h_in(0) = h0,
//       written over hloc.  The chunk's decay is one exp of a sum, <= 1 and
//       never divided by: under strong decay it is 0 and nothing overflows;
//   `ssm_scan_fwd_kernel`  each chunk walked from h_in(c), writing y, h_last
//       (the last chunk) and, where the caller gives a `ckpt` pointer
//       (training; a template flag, so serving's build is unchanged), h
//       before tokens 0, 16, 32, ... to (B, ceil(S / 16), D, N).
// y is the same with and without checkpoints: one code path.
// Bound at (4, 2048, 1600, 16), serving (no h0, no checkpoints), of the
// function: bytes, dt and u read and y written (3 x 52.4 MB) plus B and C
// (1.0 MB) and h_last (0.4 MB), 158.7 MB, 47.4 us at 3.35 TB/s;
// operations, 210 M exps, one MUFU.EX2 each at 16 a clock an SM (132 SMs,
// 1.98 GHz: 4.18 T/s), 50.2 us.  This design walks every token twice, so
// its own floor is 2 x 50.2 us of MUFU.EX2 (dt and u read twice, 262 MB,
// 78 us, under it).  On the H100 each walk forms its 210 M exps at about
// half that rate.  In the first layout (16 states a thread) taking the
// exps, the y stores or the copies out of a copy of this file each saved a
// part in step with the instructions it issues, and deeper unrolling or
// more blocks an SM saved nothing (tools/scan_variants.py --ablate): the
// walks are bound by the latency of their chains of dependent
// instructions at the occupancy their registers allow, not by one pipe.
// Two threads a channel, 16-byte copies one add apart and y stored by rows
// each took a few per cent off; four threads a channel was slower.
//
// Backward (no atomics, two calls give equal bits).  With G_t = dL/dh_t,
// walking t from S - 1 down to 0 from R = dh_last:
//     G_t = R + g_t[d] C_t[n],   R <- decay_t G_t  (dh0 = R at the end)
//     dC_t[n] = sum_d g_t[d] h_t[d, n]
//     dB_t[n] = sum_d G_t[d, n] dt_t[d] u_t[d]
//     du_t[d] = dt_t[d] sum_n G_t B_t
//     ddt_t[d] = u_t[d] sum_n G_t B_t + sum_n G_t h_{t-1} decay_t a
//     da[d, n] = sum_{b, t} G_t h_{t-1} decay_t dt_t
// R's recurrence is linear too, so the chunks run in parallel as the
// forward's do, four launches (two where the sequence is one chunk):
//   `ssm_scan_rchunk_kernel`  each chunk but the first walked back from
//       R = 0, leaving Rloc(c) and sdt(c);
//   `ssm_scan_rcarry_kernel`  R_out(nC - 1) = dh_last, R_out(c - 1) =
//       exp(a sdt(c)) R_out(c) + Rloc(c), written over Rloc;
//   `ssm_scan_bwd_kernel`  each chunk walked back from R_out(c): four
//       states a thread (N / 4 threads a channel), each span's h before
//       each token and after its last recomputed from the forward's
//       checkpoint into 17 x 4 registers, then the span walked back with
//       h_{t-1} and h_t from there.  h_{t-1} is never recovered by dividing
//       by decay, which underflows to 0 at strong decay.  Sums over n are
//       in-thread adds and two shuffles; the sums over the warp's 8
//       channels of dB_t[n] and dC_t[n] (8 values a thread) go through a
//       transposing butterfly (4 + 2 + 1 shuffles leave one sum a lane),
//       then over the block's warps in order through shared memory, and
//       the block writes its partial dB, dC (ceil(D / 64), B, S, N), its
//       ddt and du rows (staged a span at a time) and da (B, nC, D, N);
//       dh0 is chunk 0's last R;
//   `ssm_scan_sum_kernel`  the partials added in a fixed order.
// Bound at (4, 2048, 1600, 16) without h0, of the function: bytes, dt, u
// and dy read and ddt and du written (5 x 52.4 MB), B, C, dB, dC (2.1 MB),
// dh_last and dh0 (0.8 MB) and checkpoints every 32 tokens read (26.2 MB),
// 291.2 MB, 86.9 us at 3.35 TB/s; 210 M exps at the MUFU rate, 50.2 us.
// This design forms each decay three times (the reverse chunk walk, the
// recompute, the walk back): a floor of 151 us of MUFU.EX2.  The walk back
// issues ~1 instruction an element (fp32 products, the butterfly's
// shuffles and selects) and is bound as the forward's walks are, two
// blocks of 256 threads an SM (128 registers: one block an SM ran 1.7x
// slower, two states a thread spilled and ran slower).  A whole span is
// walked without the per-token test of a short one.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kCkptEvery = 16;  // tokens between checkpoints; a span
constexpr int kChannels = 64;   // channels a block
constexpr int kNs = 4;          // states a thread in the backward's walk
constexpr int kFwdTpc = 2;      // threads a channel in the forward's walks
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct FwdParams {
  const float* dt;
  const float* u;
  const float* b;
  const float* c;
  const float* a;
  const float* h0;  // null: zeros
  float* y;
  float* h_last;
  float* ckpt;  // (B, nck, D, N); written only by the kCkpt build
  float* cbuf;  // (B, nC, D, N): hloc, then h_in; null when nC == 1
  float* sdt;   // (B, nC, D); likewise
  int B, S, D, nC, chunk, nck;
  bool vec;  // 16-byte copies
};

struct BwdParams {
  const float* dt;
  const float* u;
  const float* b;
  const float* c;
  const float* a;
  const float* dy;
  const float* dh_last;  // null: zeros
  const float* ckpt;
  float* ddt;
  float* du;
  float* dh0;
  float* part_b;   // (ceil(D / kChannels), B, S, N)
  float* part_c;   // likewise
  float* da_part;  // (B, nC, D, N)
  float* cbuf;     // (B, nC, D, N): Rloc, then R_out; null when nC == 1
  float* sdt;      // (B, nC, D); likewise
  int B, S, D, nC, chunk, nck;
  bool vec;
};

// What the chunk walks and the carry read: the forward's (dt, u, B, h0) or
// the backward's (dt, dy, C, dh_last).
struct ChunkParams {
  const float* dt;
  const float* v;   // u or dy
  const float* st;  // B or C
  const float* a;
  const float* init;  // h0 or dh_last; null: zeros
  float* cbuf;
  float* sdt;
  int B, S, D, nC, chunk;
  bool vec;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int K>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

template <int K>
__device__ __forceinline__ const float* pick(const float* const (&p)[K],
                                             int i) {
  const float* r = p[0];
#pragma unroll
  for (int j = 1; j < K; ++j)
    if (i == j) r = p[j];
  return r;
}

// A span of kCkptEvery tokens staged in shared memory: kRows channel arrays
// (token-major rows of the block's kChannels channels), then kStates state
// arrays (token-major rows of N states).  `copy` issues the span's cp.async
// copies into one stage, neighbouring threads on neighbouring addresses,
// zeros past the span's `len` tokens or past D, and commits them as a
// group: the copies of the next span fly while the block walks this one.
// A thread copies the same group of W channels of every channel row it
// takes, kStep tokens apart, so a row's address is one add from the last.
template <int N, int kRows, int kStates, int NT>
struct Span {
  static constexpr int kChan = kCkptEvery * kChannels;
  static constexpr int kState = kCkptEvery * N;
  static constexpr int kFloats = kRows * kChan + kStates * kState;
  static_assert(kChan % 4 == 0 && kState % 4 == 0, "16-byte items");

  template <int W>
  __device__ static void items(const float* const (&rows)[kRows],
                               const float* const (&st)[kStates],
                               long long row, int s0, int len, int cb, int D,
                               float* stage) {
    constexpr int kRowItems = kChannels / W, kStep = NT / kRowItems;
    static_assert(NT % kRowItems == 0 && kCkptEvery % kStep == 0,
                  "whole rows a pass");
    const int q = threadIdx.x % kRowItems, k0 = threadIdx.x / kRowItems;
    const bool ch_ok = cb + q * W < D;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float* src = rows[r] + (row + s0 + k0) * D + cb + q * W;
      float* dst = stage + r * kChan + k0 * kChannels + q * W;
#pragma unroll
      for (int i = 0; i < kCkptEvery / kStep; ++i) {
        const bool ok = ch_ok && k0 + i * kStep < len;
        put<W>(dst + i * kStep * kChannels, src, ok);
        src += (long long)kStep * D;
      }
    }
#pragma unroll 1
    for (int x = threadIdx.x; x < kStates * kState / W; x += NT) {
      const int e = x * W, i = e % kState;
      put<W>(stage + kRows * kChan + e,
             pick(st, e / kState) + (row + s0) * N + i, i / N < len);
    }
  }

  // one item: W floats copied, or zeros where !ok
  template <int W>
  __device__ static void put(float* dst, const float* src, bool ok) {
    if constexpr (W == 4) {
      if (ok)
        cp_async16(dst, src);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0, 0, 0, 0);
    } else {
      if (ok)
        cp_async4(dst, src);
      else
        *dst = 0.f;
    }
  }

  __device__ static void copy(const float* const (&rows)[kRows],
                              const float* const (&st)[kStates],
                              long long row, int s0, int len, int cb, int D,
                              bool vec, float* stage) {
    if (vec)
      items<4>(rows, st, row, s0, len, cb, D, stage);
    else
      items<1>(rows, st, row, s0, len, cb, D, stage);
    cp_commit();
  }
};

// `a` in log2 units for states n0 .. n0 + K - 1 of channel d.
template <int N, int K>
__device__ __forceinline__ void load_a(const float* a, int d, int n0,
                                       float (&an)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) an[i] = a[(long long)d * N + n0 + i] * kLog2e;
}

// K consecutive floats of shared memory, 16-byte aligned.
template <int K>
__device__ __forceinline__ void load_vec(const float* src, float (&out)[K]) {
  static_assert(K % 4 == 0, "16-byte loads");
#pragma unroll
  for (int q = 0; q < K / 4; ++q) {
    const float4 v = reinterpret_cast<const float4*>(src)[q];
    out[4 * q] = v.x;
    out[4 * q + 1] = v.y;
    out[4 * q + 2] = v.z;
    out[4 * q + 3] = v.w;
  }
}

// Threads a channel in the forward's walks (N / that many states each).
template <int N>
__host__ __device__ constexpr int fwd_tpc() {
  return N >= 4 * kFwdTpc ? kFwdTpc : 1;
}

// A chunk walked from a zero state: forward (h = decay h + dt u B, tokens
// in order) for chunks 0 .. nC - 2, or reverse (R = decay (R + dy C),
// tokens from the last) for chunks 1 .. nC - 1.  Leaves the state and the
// chunk's sum of dt (in walking order) in cbuf and sdt.
template <int N, bool kRev>
__device__ __forceinline__ void chunk_walk(const ChunkParams& p) {
  constexpr int TPC = fwd_tpc<N>(), NS = N / TPC, NT = kChannels * TPC;
  using Sp = Span<N, 2, 1, NT>;
  __shared__ __align__(16) float stage[2][Sp::kFloats];
  const int j = threadIdx.x % TPC, lc = threadIdx.x / TPC, n0 = j * NS;
  const int cb = blockIdx.x * kChannels, d = cb + lc;
  const int ck = blockIdx.y + (kRev ? 1 : 0), bi = blockIdx.z;
  const bool live = d < p.D;
  const int dd = live ? d : p.D - 1;
  const long long row = (long long)bi * p.S;
  const int t0 = ck * p.chunk, t1 = min(p.S, t0 + p.chunk);
  const int nspan = (t1 - t0 + kCkptEvery - 1) / kCkptEvery;
  float an[NS], x[NS];
  load_a<N, NS>(p.a, dd, n0, an);
#pragma unroll
  for (int i = 0; i < NS; ++i) x[i] = 0.f;
  float sdt = 0.f;
  const float* const rows[2] = {p.dt, p.v};
  const float* const st[1] = {p.st};
  auto span_start = [&](int m) { return t0 + m * kCkptEvery; };
  auto span_len = [&](int m) { return min(kCkptEvery, t1 - span_start(m)); };
  {
    const int m = kRev ? nspan - 1 : 0;
    Sp::copy(rows, st, row, span_start(m), span_len(m), cb, p.D, p.vec,
             stage[0]);
  }
  for (int it = 0; it < nspan; ++it) {
    const int m = kRev ? nspan - 1 - it : it;
    if (it + 1 < nspan) {
      const int mn = kRev ? m - 1 : m + 1;
      Sp::copy(rows, st, row, span_start(mn), span_len(mn), cb, p.D, p.vec,
               stage[(it + 1) & 1]);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* s_dt = stage[it & 1];
    const float* s_v = s_dt + Sp::kChan;
    const float* s_st = s_dt + 2 * Sp::kChan;
    const int len = span_len(m);
#pragma unroll 2
    for (int kk = 0; kk < len; ++kk) {
      const int k = kRev ? len - 1 - kk : kk;
      const float dt = s_dt[k * kChannels + lc];
      const float v = s_v[k * kChannels + lc];
      float w[NS];
      load_vec(s_st + k * N + n0, w);
      sdt += dt;
      const float dv = dt * v;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float dec = ex2(dt * an[i]);
        if (kRev)
          x[i] = dec * __fmaf_rn(v, w[i], x[i]);
        else
          x[i] = __fmaf_rn(dec, x[i], dv * w[i]);
      }
    }
    __syncthreads();
  }
  if (live) {
    const long long base = ((long long)bi * p.nC + ck) * p.D + d;
#pragma unroll
    for (int i = 0; i < NS; ++i) p.cbuf[base * N + n0 + i] = x[i];
    if (j == 0) p.sdt[base] = sdt;
  }
}

template <int N>
__global__ void __launch_bounds__(kChannels * fwd_tpc<N>(), 8 / fwd_tpc<N>())
    ssm_scan_chunk_kernel(ChunkParams p) {
  chunk_walk<N, false>(p);
}

template <int N>
__global__ void __launch_bounds__(kChannels * fwd_tpc<N>(), 8 / fwd_tpc<N>())
    ssm_scan_rchunk_kernel(ChunkParams p) {
  chunk_walk<N, true>(p);
}

// The carry over chunks, one thread a (b, d, n): x from init (h0 or
// dh_last), then for each chunk in walking order its slot of cbuf takes x
// and x = exp(a sdt) x + the chunk's local state (the last chunk walked has
// none).  The slots are read kCarryGroup at a time before any is written
// (cbuf is read and written in place, so the loads would otherwise wait
// for each store).
constexpr int kCarryGroup = 8;

template <int N, bool kRev>
__device__ __forceinline__ void carry(const ChunkParams& p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long dn = (long long)p.D * N;
  if (i >= (long long)p.B * dn) return;
  const int n = (int)(i % N);
  const int d = (int)((i / N) % p.D);
  const long long bi = i / dn;
  const float an = p.a[(long long)d * N + n] * kLog2e;
  float x = p.init != nullptr ? p.init[i] : 0.f;
  for (int j0 = 0; j0 < p.nC; j0 += kCarryGroup) {
    float loc[kCarryGroup], sd[kCarryGroup];
#pragma unroll
    for (int q = 0; q < kCarryGroup; ++q) {
      const int j = j0 + q, c = kRev ? p.nC - 1 - j : j;
      const long long slot = (bi * p.nC + c) * p.D + d;
      loc[q] = j + 1 < p.nC ? p.cbuf[slot * N + n] : 0.f;
      sd[q] = j + 1 < p.nC ? p.sdt[slot] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < kCarryGroup; ++q) {
      const int j = j0 + q, c = kRev ? p.nC - 1 - j : j;
      if (j < p.nC) {
        p.cbuf[((bi * p.nC + c) * p.D + d) * N + n] = x;
        x = __fmaf_rn(ex2(an * sd[q]), x, loc[q]);
      }
    }
  }
}

template <int N>
__global__ void __launch_bounds__(256) ssm_scan_carry_kernel(ChunkParams p) {
  carry<N, false>(p);
}

template <int N>
__global__ void __launch_bounds__(256) ssm_scan_rcarry_kernel(ChunkParams p) {
  carry<N, true>(p);
}

template <int N, bool kCkpt>
__global__ void __launch_bounds__(kChannels * fwd_tpc<N>(), 8 / fwd_tpc<N>())
    ssm_scan_fwd_kernel(FwdParams p) {
  constexpr int TPC = fwd_tpc<N>(), NS = N / TPC, NT = kChannels * TPC;
  using Sp = Span<N, 2, 2, NT>;
  __shared__ __align__(16) float stage[2][Sp::kFloats];
  __shared__ __align__(16) float ys_s[kCkptEvery * kChannels];  // a span's y
  const int j = threadIdx.x % TPC, lc = threadIdx.x / TPC, n0 = j * NS;
  const int cb = blockIdx.x * kChannels, d = cb + lc;
  const int ck = blockIdx.y, bi = blockIdx.z;
  const bool live = d < p.D;
  const int dd = live ? d : p.D - 1;
  const long long row = (long long)bi * p.S;
  const int t0 = ck * p.chunk, t1 = min(p.S, t0 + p.chunk);
  float an[NS], h[NS];
  load_a<N, NS>(p.a, dd, n0, an);
  // lanes past D walk zeros (their dt and u were staged as 0)
  const float* hin =
      p.nC > 1 ? p.cbuf + (((long long)bi * p.nC + ck) * p.D + dd) * N
               : (p.h0 != nullptr ? p.h0 + ((long long)bi * p.D + dd) * N
                                  : nullptr);
#pragma unroll
  for (int i = 0; i < NS; ++i)
    h[i] = (hin != nullptr && live) ? hin[n0 + i] : 0.f;
  const float* const rows[2] = {p.dt, p.u};
  const float* const st[2] = {p.b, p.c};
  Sp::copy(rows, st, row, t0, min(kCkptEvery, t1 - t0), cb, p.D, p.vec,
           stage[0]);
  for (int s0 = t0, it = 0; s0 < t1; s0 += kCkptEvery, ++it) {
    const int len = min(kCkptEvery, t1 - s0);
    if (s0 + kCkptEvery < t1) {
      Sp::copy(rows, st, row, s0 + kCkptEvery,
               min(kCkptEvery, t1 - s0 - kCkptEvery), cb, p.D, p.vec,
               stage[(it + 1) & 1]);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* s_dt = stage[it & 1];
    const float* s_u = s_dt + Sp::kChan;
    const float* s_b = s_dt + 2 * Sp::kChan;
    const float* s_c = s_b + Sp::kState;
    if (kCkpt && live) {
      float4* dst = reinterpret_cast<float4*>(
          p.ckpt +
          (((long long)bi * p.nck + s0 / kCkptEvery) * p.D + d) * N + n0);
#pragma unroll
      for (int q = 0; q < NS / 4; ++q)
        dst[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2],
                             h[4 * q + 3]);
    }
#pragma unroll 2
    for (int k = 0; k < len; ++k) {
      const float dt = s_dt[k * kChannels + lc];
      const float du = dt * s_u[k * kChannels + lc];
      float bs[NS], cs[NS];
      load_vec(s_b + k * N + n0, bs);
      load_vec(s_c + k * N + n0, cs);
      float ys[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        h[i] = __fmaf_rn(ex2(dt * an[i]), h[i], du * bs[i]);
        ys[i % 4] = __fmaf_rn(h[i], cs[i], ys[i % 4]);
      }
      float y = (ys[0] + ys[1]) + (ys[2] + ys[3]);
#pragma unroll
      for (int o = 1; o < TPC; o *= 2) y += __shfl_xor_sync(0xffffffffu, y, o);
      if (j == 0) ys_s[k * kChannels + lc] = y;
    }
    __syncthreads();
    // the span's y as whole rows of the block's channels
    for (int i = threadIdx.x; i < len * kChannels; i += NT) {
      const int k = i / kChannels, ch = i % kChannels;
      if (cb + ch < p.D)
        p.y[(row + s0 + k) * p.D + cb + ch] = ys_s[k * kChannels + ch];
    }
  }
  if (live && ck == p.nC - 1) {
#pragma unroll
    for (int i = 0; i < NS; ++i)
      p.h_last[((long long)bi * p.D + d) * N + n0 + i] = h[i];
  }
}

// The sum over the warp's channels of NV values a lane (TPC lanes a
// channel, its channels on the lane bits from TPC up), transposed: each
// halving step keeps the half of the values that the lane's bit selects
// and adds the partner's copy of it, so log2(NV) steps of NV / 2, ...,
// 1 shuffles leave one sum a lane (`reduce_index` says which value), and
// the rest of the channel bits, if any, are summed whole.
template <int NV, int TPC>
__device__ __forceinline__ float channel_reduce(float (&v)[NV], int lane) {
  static_assert(NV <= 32 / TPC, "one sum a lane at most");
  int m = NV;
#pragma unroll
  for (int o = 16; o >= TPC; o /= 2) {
    if (m > 1) {
      const int half = m / 2;
      const bool up = (lane & o) != 0;
#pragma unroll
      for (int i = 0; i < NV / 2; ++i) {
        if (i < half) {
          const float send = up ? v[i] : v[i + half];
          const float keep = up ? v[i + half] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
        }
      }
      m = half;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
    }
  }
  return v[0];
}

// Which of the NV values `channel_reduce` leaves its sum of in `lane`.
template <int NV, int TPC>
__device__ __forceinline__ int reduce_index(int lane) {
  int idx = 0, m = NV;
#pragma unroll
  for (int o = 16; o >= TPC && m > 1; o /= 2) {
    if (lane & o) idx += m / 2;
    m /= 2;
  }
  return idx;
}

template <int N>
__host__ __device__ constexpr int bwd_threads() {
  return kChannels * (N / kNs);
}

template <int N>
__host__ __device__ constexpr int bwd_smem_floats() {
  // two stages (dt, u, dy; B, C), then per warp, token and (kind, state)
  // the warp's dB and dC sums, then the span's ddt and du tiles
  return 2 * Span<N, 3, 2, bwd_threads<N>()>::kFloats +
         (bwd_threads<N>() / 32) * kCkptEvery * 2 * N +
         2 * kCkptEvery * (kChannels + 1);
}

template <int N>
__global__ void __launch_bounds__(kChannels * (N / kNs), 2)
    ssm_scan_bwd_kernel(BwdParams p) {
  constexpr int TPC = N / kNs, NT = bwd_threads<N>(), kWarps = NT / 32;
  constexpr int kNv = 2 * kNs, kPitch = kChannels + 1;
  using Sp = Span<N, 3, 2, NT>;
  extern __shared__ __align__(16) float smem[];
  float* red = smem + 2 * Sp::kFloats;  // [warp][token][kind][state]
  float* o_dt = red + kWarps * kCkptEvery * 2 * N;  // [token][channel]
  float* o_du = o_dt + kCkptEvery * kPitch;
  const int j = threadIdx.x % TPC, lc = threadIdx.x / TPC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cb = blockIdx.x * kChannels, d = cb + lc;
  const int ck = blockIdx.y, bi = blockIdx.z;
  const bool live = d < p.D;
  const int dd = live ? d : p.D - 1;
  const long long row = (long long)bi * p.S;
  const int t0 = ck * p.chunk, t1 = min(p.S, t0 + p.chunk);
  const int nspan = (t1 - t0 + kCkptEvery - 1) / kCkptEvery;
  const int n0 = j * kNs;
  // the lane's slot for its channel sum; lanes that hold a copy write none
  const int idx = reduce_index<kNv, TPC>(lane);
  const bool writer = (lane & (32 / kNv - 1) & ~(TPC - 1)) == 0;
  float* const slot =
      red + warp * kCkptEvery * 2 * N + (idx / kNs) * N + n0 + idx % kNs;
  float an[kNs], R[kNs], da[kNs];
  load_a<N, kNs>(p.a, dd, n0, an);
  {
    const float* rin =
        p.nC > 1
            ? p.cbuf + (((long long)bi * p.nC + ck) * p.D + dd) * N
            : (p.dh_last != nullptr
                   ? p.dh_last + ((long long)bi * p.D + dd) * N
                   : nullptr);
#pragma unroll
    for (int i = 0; i < kNs; ++i) {
      R[i] = (rin != nullptr && live) ? rin[n0 + i] : 0.f;
      da[i] = 0.f;
    }
  }
  const float* const rows[3] = {p.dt, p.u, p.dy};
  const float* const st[2] = {p.b, p.c};
  Sp::copy(rows, st, row, t0 + (nspan - 1) * kCkptEvery,
           t1 - t0 - (nspan - 1) * kCkptEvery, cb, p.D, p.vec, smem);
  for (int m = nspan - 1, it = 0; m >= 0; --m, ++it) {
    const int s0 = t0 + m * kCkptEvery, len = min(kCkptEvery, t1 - s0);
    if (m > 0) {
      Sp::copy(rows, st, row, s0 - kCkptEvery, kCkptEvery, cb, p.D, p.vec,
               smem + ((it + 1) & 1) * Sp::kFloats);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    // h before each token of the span and after its last (hist[k] before
    // token k), recomputed from the checkpoint as the forward computed it;
    // lanes past D walk zeros (their dt, u and dy were staged as 0)
    float hist[kCkptEvery + 1][kNs];
    {
      const float* ck0 =
          p.ckpt + (((long long)bi * p.nck + s0 / kCkptEvery) * p.D + dd) * N +
          n0;
#pragma unroll
      for (int i = 0; i < kNs; ++i) hist[0][i] = live ? ck0[i] : 0.f;
    }
    __syncthreads();
    const float* s_dt = smem + (it & 1) * Sp::kFloats;
    const float* s_u = s_dt + Sp::kChan;
    const float* s_dy = s_dt + 2 * Sp::kChan;
    const float* s_b = s_dt + 3 * Sp::kChan;
    const float* s_c = s_b + Sp::kState;
    // the recompute and the walk back, without the per-token test of a
    // short span where the span is whole
    auto walk = [&](auto full) {
      constexpr bool kFull = decltype(full)::value;
#pragma unroll
      for (int k = 0; k < kCkptEvery; ++k) {
        if (kFull || k < len) {
          const float dt = s_dt[k * kChannels + lc];
          const float du = dt * s_u[k * kChannels + lc];
          float bs[kNs];
          load_vec(s_b + k * N + n0, bs);
#pragma unroll
          for (int i = 0; i < kNs; ++i)
            hist[k + 1][i] = __fmaf_rn(ex2(dt * an[i]), hist[k][i], du * bs[i]);
        }
      }
#pragma unroll
      for (int k = kCkptEvery - 1; k >= 0; --k) {
        if (kFull || k < len) {
          const float dt = s_dt[k * kChannels + lc];
          const float uu = s_u[k * kChannels + lc];
          const float g = s_dy[k * kChannels + lc];
          float bs[kNs], cs[kNs];
          load_vec(s_b + k * N + n0, bs);
          load_vec(s_c + k * N + n0, cs);
          const float du = dt * uu;
          float v[kNv];  // dB terms, then dC terms
          float gb = 0.f, gha = 0.f;
#pragma unroll
          for (int i = 0; i < kNs; ++i) {
            // h_{t-1} and h_t; G_t, then R = decay G_t and G h_{t-1} decay
            const float hp = hist[k][i], ht = hist[k + 1][i];
            const float G = __fmaf_rn(g, cs[i], R[i]);
            v[i] = G * du;
            v[kNs + i] = g * ht;
            gb = __fmaf_rn(G, bs[i], gb);
            R[i] = ex2(dt * an[i]) * G;
            const float ghd = R[i] * hp;
            gha = __fmaf_rn(ghd, an[i], gha);
            da[i] = __fmaf_rn(ghd, dt, da[i]);
          }
#pragma unroll
          for (int o = 1; o < TPC; o *= 2) {
            gb += __shfl_xor_sync(0xffffffffu, gb, o);
            gha += __shfl_xor_sync(0xffffffffu, gha, o);
          }
          const float sum = channel_reduce<kNv, TPC>(v, lane);
          if (writer) slot[k * 2 * N] = sum;
          if (j == 0) {
            o_du[k * kPitch + lc] = dt * gb;
            o_dt[k * kPitch + lc] = __fmaf_rn(uu, gb, gha * kLn2);
          }
        }
      }
    };
    if (len == kCkptEvery)
      walk(std::true_type{});
    else
      walk(std::false_type{});
    __syncthreads();
    // the block's dB, dC for the span: its warps summed in order; its ddt
    // and du rows
    for (int i = threadIdx.x; i < len * 2 * N; i += NT) {
      const int k = i / (2 * N), r = i % (2 * N);
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        s += red[(w * kCkptEvery + k) * 2 * N + r];
      float* part = r < N ? p.part_b : p.part_c;
      part[(((long long)blockIdx.x * p.B + bi) * p.S + s0 + k) * N + r % N] = s;
    }
    for (int i = threadIdx.x; i < len * kChannels; i += NT) {
      const int k = i / kChannels, ch = i % kChannels;
      if (cb + ch < p.D) {
        const long long off = (row + s0 + k) * p.D + cb + ch;
        p.ddt[off] = o_dt[k * kPitch + ch];
        p.du[off] = o_du[k * kPitch + ch];
      }
    }
  }
  if (live) {
    const long long hix = ((long long)bi * p.D + d) * N + n0;
    const long long dix = (((long long)bi * p.nC + ck) * p.D + d) * N + n0;
#pragma unroll
    for (int i = 0; i < kNs; ++i) {
      if (ck == 0) p.dh0[hix + i] = R[i];
      p.da_part[dix + i] = da[i];
    }
  }
}

// dB, dC = the partials summed over the channel blocks, in order; da =
// da_part summed over (b, chunk), in order.  One thread an output.
__global__ void __launch_bounds__(256)
    ssm_scan_sum_kernel(const float* __restrict__ part_b,
                        const float* __restrict__ part_c,
                        const float* __restrict__ da_part,
                        float* __restrict__ db, float* __restrict__ dc,
                        float* __restrict__ da, int nblk, long long bsn,
                        int nda, long long dn) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < bsn) {
    float sb = 0.f, sc = 0.f;
    for (int j = 0; j < nblk; ++j) {
      sb += part_b[j * bsn + i];
      sc += part_c[j * bsn + i];
    }
    db[i] = sb;
    dc[i] = sc;
  } else if (i < bsn + dn) {
    const long long k = i - bsn;
    float s = 0.f;
    for (int j = 0; j < nda; ++j) s += da_part[j * dn + k];
    da[k] = s;
  }
}

dim3 chunk_grid(int D, int chunks, int B) {
  return dim3((D + kChannels - 1) / kChannels, chunks, B);
}

unsigned carry_blocks(int B, int D, int N) {
  return (unsigned)(((long long)B * D * N + 255) / 256);
}

template <int N>
cudaError_t launch_fwd(const FwdParams& p, cudaStream_t st) {
  if (p.nC > 1) {
    const ChunkParams c{p.dt, p.u, p.b,    p.a,  p.h0,    p.cbuf,
                        p.sdt, p.B, p.S, p.D, p.nC, p.chunk, p.vec};
    ssm_scan_chunk_kernel<N><<<chunk_grid(p.D, p.nC - 1, p.B),
                               kChannels * fwd_tpc<N>(), 0, st>>>(c);
    ssm_scan_carry_kernel<N><<<carry_blocks(p.B, p.D, N), 256, 0, st>>>(c);
  }
  const dim3 grid = chunk_grid(p.D, p.nC, p.B);
  const int threads = kChannels * fwd_tpc<N>();
  if (p.ckpt != nullptr)
    ssm_scan_fwd_kernel<N, true><<<grid, threads, 0, st>>>(p);
  else
    ssm_scan_fwd_kernel<N, false><<<grid, threads, 0, st>>>(p);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_bwd(const BwdParams& p, cudaStream_t st) {
  if (p.nC > 1) {
    const ChunkParams c{p.dt, p.dy, p.c,   p.a,  p.dh_last, p.cbuf,
                        p.sdt, p.B, p.S, p.D, p.nC,      p.chunk, p.vec};
    ssm_scan_rchunk_kernel<N><<<chunk_grid(p.D, p.nC - 1, p.B),
                                kChannels * fwd_tpc<N>(), 0, st>>>(c);
    ssm_scan_rcarry_kernel<N><<<carry_blocks(p.B, p.D, N), 256, 0, st>>>(c);
  }
  const int smem = (int)sizeof(float) * bwd_smem_floats<N>();
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  ssm_scan_bwd_kernel<N>
      <<<chunk_grid(p.D, p.nC, p.B), bwd_threads<N>(), smem, st>>>(p);
  return cudaGetLastError();
}

bool valid(int B, int S, int D, int N, int chunk) {
  return B >= 1 && B <= 65535 && S >= 1 && D >= 1 && (N == 4 || N == 16) &&
         chunk >= kCkptEvery && chunk % kCkptEvery == 0 &&
         (S + chunk - 1) / chunk <= 65535;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// ckpt: (B, ceil(S / 16), D, N), 16-byte aligned, or null (serving: none
// written).  chunk: tokens a chunk, a multiple of 16.  cbuf (B, nC, D, N)
// and sdt (B, nC, D) with nC = ceil(S / chunk): scratch, null when nC is 1.
extern "C" int ssm_scan_fwd(const void* dt, const void* u, const void* b,
                            const void* c, const void* a, const void* h0,
                            void* y, void* h_last, void* ckpt, void* cbuf,
                            void* sdt, int B, int S, int D, int N, int chunk,
                            void* stream) {
  if (!valid(B, S, D, N, chunk) || (ckpt != nullptr && !aligned16(ckpt)))
    return (int)cudaErrorInvalidValue;
  FwdParams p;
  p.dt = static_cast<const float*>(dt);
  p.u = static_cast<const float*>(u);
  p.b = static_cast<const float*>(b);
  p.c = static_cast<const float*>(c);
  p.a = static_cast<const float*>(a);
  p.h0 = static_cast<const float*>(h0);
  p.y = static_cast<float*>(y);
  p.h_last = static_cast<float*>(h_last);
  p.ckpt = static_cast<float*>(ckpt);
  p.cbuf = static_cast<float*>(cbuf);
  p.sdt = static_cast<float*>(sdt);
  p.B = B;
  p.S = S;
  p.D = D;
  p.chunk = chunk;
  p.nC = (S + chunk - 1) / chunk;
  p.nck = (S + kCkptEvery - 1) / kCkptEvery;
  if (p.nC > 1 && (cbuf == nullptr || sdt == nullptr))
    return (int)cudaErrorInvalidValue;
  p.vec = D % 4 == 0 && aligned16(dt) && aligned16(u) && aligned16(b) &&
          aligned16(c);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 4: return (int)launch_fwd<4>(p, st);
    default: return (int)launch_fwd<16>(p, st);
  }
}

extern "C" const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// ckpt: the forward's checkpoints of the same inputs; dy and dh_last may
// be null (zeros).  Scratch: part_b and part_c (ceil(D / 64), B, S, N),
// da_part (B, nC, D, N), and where nC > 1 cbuf (B, nC, D, N) and sdt (B,
// nC, D).
extern "C" int ssm_scan_bwd(const void* dt, const void* u, const void* b,
                            const void* c, const void* a, const void* dy,
                            const void* dh_last, const void* ckpt, void* ddt,
                            void* du, void* db, void* dc, void* da,
                            void* dh0, void* part_b, void* part_c,
                            void* da_part, void* cbuf, void* sdt, int B,
                            int S, int D, int N, int chunk, void* stream) {
  if (!valid(B, S, D, N, chunk) || dy == nullptr || ckpt == nullptr)
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.dt = static_cast<const float*>(dt);
  p.u = static_cast<const float*>(u);
  p.b = static_cast<const float*>(b);
  p.c = static_cast<const float*>(c);
  p.a = static_cast<const float*>(a);
  p.dy = static_cast<const float*>(dy);
  p.dh_last = static_cast<const float*>(dh_last);
  p.ckpt = static_cast<const float*>(ckpt);
  p.ddt = static_cast<float*>(ddt);
  p.du = static_cast<float*>(du);
  p.dh0 = static_cast<float*>(dh0);
  p.part_b = static_cast<float*>(part_b);
  p.part_c = static_cast<float*>(part_c);
  p.da_part = static_cast<float*>(da_part);
  p.cbuf = static_cast<float*>(cbuf);
  p.sdt = static_cast<float*>(sdt);
  p.B = B;
  p.S = S;
  p.D = D;
  p.chunk = chunk;
  p.nC = (S + chunk - 1) / chunk;
  p.nck = (S + kCkptEvery - 1) / kCkptEvery;
  if (p.nC > 1 && (cbuf == nullptr || sdt == nullptr))
    return (int)cudaErrorInvalidValue;
  p.vec = D % 4 == 0 && aligned16(dt) && aligned16(u) && aligned16(dy) &&
          aligned16(b) && aligned16(c);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (N) {
    case 4: err = launch_bwd<4>(p, st); break;
    default: err = launch_bwd<16>(p, st); break;
  }
  if (err != cudaSuccess) return (int)err;
  const long long bsn = (long long)B * S * N, dn = (long long)D * N;
  const long long blocks = (bsn + dn + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ssm_scan_sum_kernel<<<(unsigned)blocks, 256, 0, st>>>(
      p.part_b, p.part_c, p.da_part, static_cast<float*>(db),
      static_cast<float*>(dc), static_cast<float*>(da),
      (D + kChannels - 1) / kChannels, bsn, B * p.nC, dn);
  return (int)cudaGetLastError();
}
