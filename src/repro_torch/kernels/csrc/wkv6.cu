// WKV6 (the RWKV6 "Finch" time-mix recurrence) for Hopper (sm_90a), bound
// to Python with ctypes.
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
// Bound at the serving path's shape (B=4, S=2048, H=40, hd=64, fp32) on
// an H100 SXM: r, k, v, w in and y out are 5 x 83.9 MB, plus 5.2 MB of
// state in and out, ~0.127 ms at 3.35 TB/s; the recurrence is
// 4*B*S*H*hd^2 ~ 5.4 GFLOP, ~0.080 ms at 67 TFLOP/s fp32.  So it is bound
// by bytes.
//
// Design (the sequential recurrence, parallel over state elements; simple
// and exact first, no TMA / tensor cores: tf32 would miss the 1e-4 bar):
//  * Column j of S depends only on v[:, j], so the grid is
//    (B*H, hd / VT): each block owns VT value columns of one head.  A
//    thread holds 8 rows of one column in registers; the G = hd / 8
//    threads of a column are neighbouring lanes of one warp.
//  * A block stages `chunk` tokens of r, k, w (hd wide) and v (VT wide)
//    in shared memory with coalesced loads, computes each token's bonus
//    scalar r_t . (u * k_t) once (one warp per token), then walks the
//    tokens in order: per token a thread reads its rows of r, k, w as
//    two float4 broadcasts, forms its part of r_t S with the state before
//    the update, updates its rows, and the G lanes of a column sum their
//    parts with xor-shuffles.  y is collected in shared memory and stored
//    coalesced after the chunk.
//  * Tokens past S are never loaded or walked; `chunk` only sets how many
//    tokens are staged at a time and does not change the result.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;  // state rows a thread holds (one column)

template <int HD>
struct Cfg {
  static constexpr int kG = HD / kRows;                        // lanes per column
  static constexpr int kVT = (HD < 256 / kG) ? HD : 256 / kG;  // columns per block
  static constexpr int kThreads = kG * kVT;
};

struct Params {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;   // (H, hd), contiguous
  const float* s0;  // (B, H, hd, hd), contiguous, or null for zeros
  float* y;
  float* s_final;   // (B, H, hd, hd), contiguous
  long long sr[3], sk[3], sv[3], sw[3], sy[3];  // element strides of b, s, h
  int H, S, chunk;
};

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::kThreads)
    wkv6_kernel(const Params p) {
  constexpr int G = Cfg<HD>::kG;
  constexpr int VT = Cfg<HD>::kVT;
  constexpr int NT = Cfg<HD>::kThreads;
  constexpr int NW = (NT + 31) / 32;
  extern __shared__ float4 smem4[];
  float* rs = reinterpret_cast<float*>(smem4);
  const int C = p.chunk;
  float* ks = rs + C * HD;
  float* ws = ks + C * HD;
  float* vs = ws + C * HD;  // (C, VT)
  float* ys = vs + C * VT;  // (C, VT)
  float* bon = ys + C * VT; // (C,)

  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int j0 = blockIdx.y * VT;
  const int tid = threadIdx.x;
  const int g = tid % G, c = tid / G;
  const int j = j0 + c;
  const int lane = tid & 31, warp = tid >> 5;

  const float* rb = p.r + b * p.sr[0] + h * p.sr[2];
  const float* kb = p.k + b * p.sk[0] + h * p.sk[2];
  const float* vb = p.v + b * p.sv[0] + h * p.sv[2];
  const float* wb = p.w + b * p.sw[0] + h * p.sw[2];
  float* yb = p.y + b * p.sy[0] + h * p.sy[2];
  const float* ub = p.u + (long long)h * HD;
  const long long sbase = (long long)bh * HD * HD;

  // Thread g holds rows 4*(g + G*q) + e, q < kRows/4, e < 4, of column j.
  float st[kRows];
#pragma unroll
  for (int q = 0; q < kRows / 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * (g + G * q) + e;
      st[4 * q + e] = p.s0 ? p.s0[sbase + (long long)i * HD + j] : 0.f;
    }

  for (int t0 = 0; t0 < p.S; t0 += C) {
    const int n = min(C, p.S - t0);
    for (int idx = tid; idx < n * HD; idx += NT) {
      const long long t = t0 + idx / HD;
      const int i = idx % HD;
      rs[idx] = rb[t * p.sr[1] + i];
      ks[idx] = kb[t * p.sk[1] + i];
      ws[idx] = wb[t * p.sw[1] + i];
    }
    for (int idx = tid; idx < n * VT; idx += NT) {
      const long long t = t0 + idx / VT;
      vs[idx] = vb[t * p.sv[1] + j0 + idx % VT];
    }
    __syncthreads();
    for (int t = warp; t < n; t += NW) {  // bonus: r_t . (u * k_t)
      float s = 0.f;
      for (int i = lane; i < HD; i += 32)
        s = fmaf(rs[t * HD + i] * ub[i], ks[t * HD + i], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) bon[t] = s;
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const float4* r4 = reinterpret_cast<const float4*>(rs + t * HD);
      const float4* k4 = reinterpret_cast<const float4*>(ks + t * HD);
      const float4* w4 = reinterpret_cast<const float4*>(ws + t * HD);
      const float vj = vs[t * VT + c];
      float part = 0.f;
#pragma unroll
      for (int q = 0; q < kRows / 4; ++q) {
        const float4 rr = r4[g + G * q];
        const float4 kk = k4[g + G * q];
        const float4 ww = w4[g + G * q];
        const int o = 4 * q;
        part = fmaf(rr.x, st[o + 0], part);
        part = fmaf(rr.y, st[o + 1], part);
        part = fmaf(rr.z, st[o + 2], part);
        part = fmaf(rr.w, st[o + 3], part);
        st[o + 0] = fmaf(ww.x, st[o + 0], kk.x * vj);
        st[o + 1] = fmaf(ww.y, st[o + 1], kk.y * vj);
        st[o + 2] = fmaf(ww.z, st[o + 2], kk.z * vj);
        st[o + 3] = fmaf(ww.w, st[o + 3], kk.w * vj);
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (g == 0) ys[t * VT + c] = fmaf(vj, bon[t], part);
    }
    __syncthreads();
    for (int idx = tid; idx < n * VT; idx += NT) {
      const long long t = t0 + idx / VT;
      yb[t * p.sy[1] + j0 + idx % VT] = ys[idx];
    }
    // The next chunk's staging writes rs/ks/ws/vs/bon only (all read
    // before the barrier above); ys is rewritten after two more barriers.
  }

#pragma unroll
  for (int q = 0; q < kRows / 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * (g + G * q) + e;
      p.s_final[sbase + (long long)i * HD + j] = st[4 * q + e];
    }
}

template <int HD>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int VT = Cfg<HD>::kVT;
  const size_t smem =
      sizeof(float) * ((size_t)p.chunk * (3 * HD + 2 * VT) + p.chunk);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * p.H, HD / VT);
  wkv6_kernel<HD><<<grid, Cfg<HD>::kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int wkv6_fwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0,
                        void* y, void* s_final, int B, int S, int H, int hd,
                        long long r_sb, long long r_ss, long long r_sh,
                        long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh,
                        long long w_sb, long long w_ss, long long w_sh,
                        long long y_sb, long long y_ss, long long y_sh,
                        int chunk, void* stream) {
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
  const long long strides[5][3] = {{r_sb, r_ss, r_sh}, {k_sb, k_ss, k_sh},
                                   {v_sb, v_ss, v_sh}, {w_sb, w_ss, w_sh},
                                   {y_sb, y_ss, y_sh}};
  long long* dst[5] = {p.sr, p.sk, p.sv, p.sw, p.sy};
  for (int a = 0; a < 5; ++a)
    for (int d = 0; d < 3; ++d) dst[a][d] = strides[a][d];
  p.H = H;
  p.S = S;
  p.chunk = chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return (int)launch<16>(p, B, st);
    case 32: return (int)launch<32>(p, B, st);
    case 64: return (int)launch<64>(p, B, st);
    case 128: return (int)launch<128>(p, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
