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
// in the inputs' dtype (fp32 or bf16), all arithmetic in fp32.  It honours
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
// ~0.17 ms at 989 TFLOP/s; q, k, v, o, dO read and dq, dk, dv written are
// ~270 MB, ~0.08 ms at 3.35 TB/s.  So it is bound by tensor-core operations
// at ~0.17 ms.
//
// Design: simple and right, not fast.  Three launches a call, no atomics
// (deterministic), SIMT fp32 on the FMA units, where the bound's products
// take >= 2.6 ms at 67 TFLOP/s (this kernel does 7 hd-long FMA chains a
// visible pair, ~240 GFLOP at that shape, so >= 3.6 ms); the tensor cores
// are left to a later redesign.
//  1. delta: one warp per row.
//  2. dK / dV: one block per (b*h, tile of kRows keys); TPR threads per key
//     row hold a share of its k, v, dk and dv in registers (at most 16 floats
//     each: TPR = 4 up to hd 64, hd / 16 above).  The block walks the q rows
//     that see a key of its tile (the forward's kv_range turned around:
//     from k0 - q_offset under a causal mask, to k0 + kRows - 1 + window -
//     q_offset under a window), staging kTile rows of q and dO in shared
//     memory (two fp32 tiles, 32 KB at most) with their lse and delta, read
//     by broadcast.
//  3. dQ: one block per (b*h, tile of kRows q rows), heaviest first; q, dO
//     and dq of a row in registers across TPR threads, the forward's
//     kv_range over kTile-key tiles of k and v staged in shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

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
  int qlo = 0, qhi = p.Sq;
  if (p.causal) qlo = max(0, k0 - p.q_offset);
  if (p.window > 0)
    qhi = static_cast<int>(min(static_cast<long long>(p.Sq),
                               static_cast<long long>(k0) + C::kRows - 1 +
                                   p.window - p.q_offset));
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

template <int HD, typename T>
int launch(const Params& p, int B, cudaStream_t stream) {
  using C = Cfg<HD>;
  const long long rows = static_cast<long long>(B) * p.H * p.Sq;
  const long long delta_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  const int n_k = (p.Skv + C::kRows - 1) / C::kRows;
  const int n_q = (p.Sq + C::kRows - 1) / C::kRows;
  if (delta_blocks > INT_MAX || static_cast<long long>(B) * p.H > INT_MAX ||
      n_k > 65535 || n_q > 65535)
    return (int)cudaErrorInvalidConfiguration;
  flash_bwd_delta<HD, T><<<static_cast<unsigned>(delta_blocks), kThreads, 0,
                           stream>>>(p, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv<HD, T><<<dim3(B * p.H, n_k), kThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq<HD, T><<<dim3(B * p.H, n_q), kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int HD>
int launch(const Params& p, int dtype, int B, cudaStream_t stream) {
  return dtype == 0 ? launch<HD, float>(p, B, stream)
                    : launch<HD, __nv_bfloat16>(p, B, stream);
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

extern "C" const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
