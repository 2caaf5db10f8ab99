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
// (4, 2048, 1600, 16)).  Rounding: expf (no fast math), drive = (dt u) B,
// h = fma(decay, h, drive); the plain loop rounds decay h and the sum
// apart, so the two differ by an ulp a step.
//
// Forward (`ssm_scan_fwd_kernel`): one thread per (b, d, n); a block holds
// kChannels = 32 channels of one batch row, so the N lanes of a channel
// are neighbours in one warp and reduce y by shuffles.  The grid is
// (ceil(D / 32), B): 200 blocks of 512 threads at (4, 2048, 1600, 16),
// resident in one wave.  The tokens go in spans of kCkptEvery = 32: a
// span's dt and u (32 tokens x 32 channels, rows of 128 bytes) and B and
// C are copied into one of two shared-memory stages with cp.async while
// the block walks the span before from the other (`Span`; a copy loop
// that is not unrolled, so its addresses take no registers during the
// walk), and the walk reads them from there (dt and u one address per
// channel, broadcast to its lanes).  y is staged a span at a time too and
// stored as whole rows of 32 channels.  Where the caller gives a `ckpt`
// pointer (training; a template flag, so serving's build is unchanged),
// the kernel also writes h before tokens 0, 32, 64, ... to (B, ceil(S /
// 32), D, N).
// Bound at (4, 2048, 1600, 16), serving (no h0, no checkpoints): bytes, dt
// and u read and y written (3 x 52.4 MB) plus B and C (1.0 MB) and h_last
// (0.4 MB), 158.7 MB, 47.4 us at 3.35 TB/s; operations, 210 M expf, one
// MUFU.EX2 each at 16 a clock an SM (132 SMs, 1.98 GHz: 4.18 T/s), 50.2
// us, and ~7 fp32 operations per (b, t, d, n), 1.47 GFLOP, 21.9 us at 67
// TFLOP/s.  The walk itself issues ~25 instructions per (b, t, d, n)
// (shared loads, the expf's range reduction, the update, a 4-step shuffle
// sum over the 16 lanes), ~0.18 ms at 4 warp instructions a clock an SM,
// and its chain of dependent steps per token is what binds this design,
// not bytes.
//
// Backward (`ssm_scan_bwd_kernel`, then `ssm_scan_sum_kernel`; no
// atomics, two calls give equal bits).  With G_t = dL/dh_t, walking t from
// S - 1 down to 0 from R = dh_last:
//     G_t = R + g_t[d] C_t[n],   R <- decay_t G_t  (dh0 = R at the end)
//     dC_t[n] = sum_d g_t[d] h_t[d, n]
//     dB_t[n] = sum_d G_t[d, n] dt_t[d] u_t[d]
//     du_t[d] = dt_t[d] sum_n G_t B_t
//     ddt_t[d] = u_t[d] sum_n G_t B_t + sum_n G_t h_{t-1} decay_t a
//     da[d, n] = sum_{b, t} G_t h_{t-1} decay_t dt_t
// The same thread layout walks the spans from the last, each staged as the
// forward stages it (dt, u and dy) with the span before it in flight: it
// recomputes h before each token of the span from the forward's
// checkpoint into 32 registers, then walks the span back, forming h_t
// from h_{t-1} exactly as the recompute does.  h_{t-1} is never recovered
// by dividing by decay, which underflows to 0 at strong decay (exp(-16
// dt)).  Sums over n are shuffles; sums over d go across the block's
// warps through shared memory once a span, and the block writes its
// partial dB, dC (ceil(D / 32), B, S, N) and da (B, D, N); the second
// launch adds the partials in a fixed order.  ddt and du are staged a
// span at a time and stored as whole rows.  Its launch bounds ask for two
// blocks an SM (64 registers a thread at N = 16, no spills; one block an
// SM ran slower).
// Bound at (4, 2048, 1600, 16) without h0: bytes, dt, u and dy read and
// ddt and du written (5 x 52.4 MB), B, C, dB, dC (2.1 MB), dh_last and
// dh0 (0.8 MB) and the checkpoints read (26.2 MB), 291.2 MB, 86.9 us at
// 3.35 TB/s; 210 M expf at the MUFU rate, 50.2 us.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCkptEvery = 32;  // tokens between checkpoints
constexpr int kChannels = 32;   // channels a block

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
  int S, D, nck;
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
  float* da_part;  // (B, D, N)
  int B, S, D, nck;
};

// One step of the recurrence, the same in the forward and in the
// backward's recompute.
__device__ __forceinline__ float advance(float h, float dt, float a,
                                         float du, float b) {
  return __fmaf_rn(expf(dt * a), h, du * b);
}

// The sum over the N lanes of one channel (neighbours in a warp), left in
// every one of them.
template <int N>
__device__ __forceinline__ float state_sum(float v) {
#pragma unroll
  for (int o = N / 2; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sum over the 32 / N channels of a warp, for each state n.
template <int N>
__device__ __forceinline__ float channel_sum(float v) {
#pragma unroll
  for (int o = N; o < 32; o *= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int K>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

// A span of kCkptEvery tokens staged in shared memory: kRows channel
// arrays (token-major rows of the block's kChannels channels; the forward
// stages dt and u, the backward dt, u and dy), then B and C (token-major
// rows of N states).  `copy` issues the span's cp.async copies into one
// stage, neighbouring threads on neighbouring addresses (a row of 32
// channels is 128 bytes), zeros past S or D, and commits them as a group:
// the copies of the next span fly while the block walks this one.
template <int N, int kRows>
struct Span {
  static constexpr int NT = kChannels * N;            // threads a block
  static constexpr int kChan = kCkptEvery * kChannels;
  static constexpr int kState = kCkptEvery * N;
  static constexpr int kFloats = kRows * kChan + 2 * kState;
  static_assert(kChan % NT == 0 && kState == NT, "whole copies a thread");

  __device__ static void copy(const float* const (&rows)[kRows],
                              const float* b, const float* c, long long row,
                              int s0, int len, int cb, int D, float* stage) {
#pragma unroll 1
    for (int j = 0; j < kFloats / NT; ++j) {
      const int x = threadIdx.x + j * NT;
      const float* src;
      bool ok;
      if (x < kRows * kChan) {
        const int i = x % kChan, k = i / kChannels, ch = i % kChannels;
        ok = k < len && cb + ch < D;
        src = rows[x / kChan] + (row + s0 + k) * D + cb + ch;
      } else {
        const int i = (x - kRows * kChan) % kState;
        ok = i / N < len;
        src = (x - kRows * kChan < kState ? b : c) + (row + s0) * N + i;
      }
      if (ok)
        cp_async4(stage + x, src);
      else
        stage[x] = 0.f;
    }
    cp_commit();
  }
};

template <int N, bool kCkpt>
__global__ void __launch_bounds__(kChannels * N)
    ssm_scan_fwd_kernel(FwdParams p) {
  using Sp = Span<N, 2>;
  __shared__ float stage[2][Sp::kFloats];
  __shared__ float ys[kCkptEvery][kChannels + 1];
  const int n = threadIdx.x % N, lc = threadIdx.x / N;
  const int cb = blockIdx.x * kChannels, d = cb + lc, bi = blockIdx.y;
  const bool live = d < p.D;
  const long long row = (long long)bi * p.S;
  const float an = p.a[(long long)(live ? d : p.D - 1) * N + n];
  const long long hix = ((long long)bi * p.D + d) * N + n;
  const float* const rows[2] = {p.dt, p.u};
  // lanes past D walk zeros (their dt and u were staged as 0)
  float h = (p.h0 != nullptr && live) ? p.h0[hix] : 0.f;
  Sp::copy(rows, p.b, p.c, row, 0, min(kCkptEvery, p.S), cb, p.D, stage[0]);
  for (int s0 = 0, it = 0; s0 < p.S; s0 += kCkptEvery, ++it) {
    const int len = min(kCkptEvery, p.S - s0);
    if (s0 + kCkptEvery < p.S) {
      Sp::copy(rows, p.b, p.c, row, s0 + kCkptEvery,
               min(kCkptEvery, p.S - s0 - kCkptEvery), cb, p.D,
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
    if (kCkpt && live)
      p.ckpt[(((long long)bi * p.nck + s0 / kCkptEvery) * p.D + d) * N + n] =
          h;
#pragma unroll 4
    for (int k = 0; k < len; ++k) {
      const float dt = s_dt[k * kChannels + lc];
      h = advance(h, dt, an, dt * s_u[k * kChannels + lc], s_b[k * N + n]);
      const float yv = state_sum<N>(h * s_c[k * N + n]);
      if (n == 0) ys[k][lc] = yv;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < len * kChannels; i += blockDim.x) {
      const int k = i / kChannels, ch = i % kChannels;
      if (cb + ch < p.D) p.y[(row + s0 + k) * p.D + cb + ch] = ys[k][ch];
    }
  }
  if (live) p.h_last[hix] = h;
}

template <int N>
constexpr int bwd_smem_floats() {
  // two stages; per warp, token and state the warp's dB and dC sums; then
  // ddt and du
  return 2 * Span<N, 3>::kFloats + 2 * (kChannels * N / 32) * kCkptEvery * N +
         2 * kCkptEvery * (kChannels + 1);
}

template <int N>
__global__ void __launch_bounds__(kChannels * N, 2)
    ssm_scan_bwd_kernel(BwdParams p) {
  using Sp = Span<N, 3>;
  constexpr int kWarps = kChannels * N / 32;
  extern __shared__ float smem[];
  // two stages, then [warp][k][n] dB and dC sums, then [k][channel] ddt
  // and du
  float* red_b = smem + 2 * Sp::kFloats;
  float* red_c = red_b + kWarps * kCkptEvery * N;
  float* o_dt = red_c + kWarps * kCkptEvery * N;
  float* o_du = o_dt + kCkptEvery * (kChannels + 1);
  const int n = threadIdx.x % N, lc = threadIdx.x / N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int cb = blockIdx.x * kChannels, d = cb + lc, bi = blockIdx.y;
  const bool live = d < p.D;
  const long long row = (long long)bi * p.S;
  const float an = p.a[(long long)(live ? d : p.D - 1) * N + n];
  const long long hix = ((long long)bi * p.D + d) * N + n;
  const float* const rows[3] = {p.dt, p.u, p.dy};
  float R = (p.dh_last != nullptr && live) ? p.dh_last[hix] : 0.f;
  float da = 0.f;
  {
    const int s0 = (p.nck - 1) * kCkptEvery;
    Sp::copy(rows, p.b, p.c, row, s0, p.S - s0, cb, p.D, smem);
  }
  for (int ck = p.nck - 1; ck >= 0; --ck) {
    const int it = p.nck - 1 - ck;
    const int s0 = ck * kCkptEvery, len = min(kCkptEvery, p.S - s0);
    if (ck > 0) {
      Sp::copy(rows, p.b, p.c, row, s0 - kCkptEvery, kCkptEvery, cb, p.D,
               smem + ((it + 1) & 1) * Sp::kFloats);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    // h before each token of the span (hist[k]), recomputed from the
    // checkpoint as the forward computed it (the walk back forms h after
    // each token the same way); lanes past D walk zeros (their dt, u and
    // dy were staged as 0)
    float hist[kCkptEvery];
    hist[0] = live
        ? p.ckpt[(((long long)bi * p.nck + ck) * p.D + d) * N + n] : 0.f;
    __syncthreads();
    const float* s_dt = smem + (it & 1) * Sp::kFloats;
    const float* s_u = s_dt + Sp::kChan;
    const float* s_dy = s_dt + 2 * Sp::kChan;
    const float* s_b = s_dt + 3 * Sp::kChan;
    const float* s_c = s_b + Sp::kState;
#pragma unroll
    for (int k = 0; k + 1 < kCkptEvery; ++k) {
      if (k + 1 < len) {
        const float dt = s_dt[k * kChannels + lc];
        hist[k + 1] = advance(hist[k], dt, an, dt * s_u[k * kChannels + lc],
                              s_b[k * N + n]);
      }
    }
#pragma unroll
    for (int k = kCkptEvery - 1; k >= 0; --k) {
      if (k < len) {
        const float dt = s_dt[k * kChannels + lc];
        const float uu = s_u[k * kChannels + lc];
        const float g = s_dy[k * kChannels + lc];
        const float bn = s_b[k * N + n], cn = s_c[k * N + n];
        const float dec = expf(dt * an), du = dt * uu;
        const float ht = __fmaf_rn(dec, hist[k], du * bn);  // as advance
        const float G = __fmaf_rn(g, cn, R);
        const float pc = channel_sum<N>(g * ht);
        const float pb = channel_sum<N>(G * du);
        const float gb = state_sum<N>(G * bn);
        const float ghd = G * hist[k] * dec;
        const float gha = state_sum<N>(ghd * an);
        da = __fmaf_rn(ghd, dt, da);
        R = dec * G;
        if (lane < N) {
          red_b[(warp * kCkptEvery + k) * N + n] = pb;
          red_c[(warp * kCkptEvery + k) * N + n] = pc;
        }
        if (n == 0) {
          o_du[k * (kChannels + 1) + lc] = dt * gb;
          o_dt[k * (kChannels + 1) + lc] = __fmaf_rn(uu, gb, gha);
        }
      }
    }
    __syncthreads();
    // the block's dB, dC for the span: its warps summed in order
    const long long pbase =
        (((long long)blockIdx.x * p.B + bi) * p.S + s0) * N;
    for (int i = threadIdx.x; i < len * N; i += blockDim.x) {
      float sb = 0.f, sc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        sb += red_b[w * kCkptEvery * N + i];
        sc += red_c[w * kCkptEvery * N + i];
      }
      p.part_b[pbase + i] = sb;
      p.part_c[pbase + i] = sc;
    }
    for (int i = threadIdx.x; i < len * kChannels; i += blockDim.x) {
      const int k = i / kChannels, ch = i % kChannels;
      if (cb + ch < p.D) {
        const long long off = (row + s0 + k) * p.D + cb + ch;
        p.ddt[off] = o_dt[k * (kChannels + 1) + ch];
        p.du[off] = o_du[k * (kChannels + 1) + ch];
      }
    }
  }
  if (live) {
    p.dh0[hix] = R;
    p.da_part[hix] = da;
  }
}

// dB, dC = the partials summed over the channel blocks, in order; da =
// da_part summed over b, in order.  One thread an output.
__global__ void __launch_bounds__(256)
    ssm_scan_sum_kernel(const float* __restrict__ part_b,
                        const float* __restrict__ part_c,
                        const float* __restrict__ da_part,
                        float* __restrict__ db, float* __restrict__ dc,
                        float* __restrict__ da, int nblk, long long bsn,
                        int B, long long dn) {
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
    for (int b = 0; b < B; ++b) s += da_part[b * dn + k];
    da[k] = s;
  }
}

template <int N>
cudaError_t launch_fwd(const FwdParams& p, int B, cudaStream_t st) {
  const dim3 grid((p.D + kChannels - 1) / kChannels, B);
  if (p.ckpt != nullptr)
    ssm_scan_fwd_kernel<N, true><<<grid, kChannels * N, 0, st>>>(p);
  else
    ssm_scan_fwd_kernel<N, false><<<grid, kChannels * N, 0, st>>>(p);
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_bwd(const BwdParams& p, cudaStream_t st) {
  const int smem = (int)sizeof(float) * bwd_smem_floats<N>();
  cudaError_t err = cudaFuncSetAttribute(
      ssm_scan_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.D + kChannels - 1) / kChannels, p.B);
  ssm_scan_bwd_kernel<N><<<grid, kChannels * N, smem, st>>>(p);
  return cudaGetLastError();
}

bool valid(int B, int S, int D, int N) {
  return B >= 1 && B <= 65535 && S >= 1 && D >= 1 &&
         (N == 4 || N == 16);
}

}  // namespace

// ckpt: (B, ceil(S / 32), D, N) or null (serving: none written).
extern "C" int ssm_scan_fwd(const void* dt, const void* u, const void* b,
                            const void* c, const void* a, const void* h0,
                            void* y, void* h_last, void* ckpt, int B, int S,
                            int D, int N, void* stream) {
  if (!valid(B, S, D, N)) return (int)cudaErrorInvalidValue;
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
  p.S = S;
  p.D = D;
  p.nck = (S + kCkptEvery - 1) / kCkptEvery;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 4: return (int)launch_fwd<4>(p, B, st);
    default: return (int)launch_fwd<16>(p, B, st);
  }
}

extern "C" const char* ssm_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// ckpt: the forward's checkpoints of the same inputs; dy and dh_last may
// be null (zeros).  Scratch: part_b and part_c (ceil(D / 32), B, S, N),
// da_part (B, D, N).
extern "C" int ssm_scan_bwd(const void* dt, const void* u, const void* b,
                            const void* c, const void* a, const void* dy,
                            const void* dh_last, const void* ckpt, void* ddt,
                            void* du, void* db, void* dc, void* da,
                            void* dh0, void* part_b, void* part_c,
                            void* da_part, int B, int S, int D, int N,
                            void* stream) {
  if (!valid(B, S, D, N) || dy == nullptr || ckpt == nullptr)
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
  p.B = B;
  p.S = S;
  p.D = D;
  p.nck = (S + kCkptEvery - 1) / kCkptEvery;
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
      (D + kChannels - 1) / kChannels, bsn, B, dn);
  return (int)cudaGetLastError();
}
