// What the flash-attention forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu) share: the mask, the walk over key tiles, and
// the 4-element loads and stores of the SIMT kernels.  Included by both,
// so the two honour causal, window, q_offset and ragged tails alike.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace flash {

constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, s, h;  // element strides; head_dim is contiguous
};

// The mask: key kpos is visible from query position qpos (qpos includes
// q_offset).  window <= 0 means no window.
__device__ __forceinline__ bool visible(int Skv, int causal, int window,
                                        int qpos, int kpos) {
  return kpos < Skv && (!causal || qpos >= kpos) &&
         (window <= 0 || qpos - kpos < window);
}

// Key tiles [lo, hi) of `bk` keys that hold a visible key for some query row
// of the tile [q0, q0 + bq).
__device__ __forceinline__ void kv_range(int Sq, int Skv, int causal,
                                         int window, int q_offset, int q0,
                                         int bq, int bk, int& lo, int& hi) {
  const int n_kv = (Skv + bk - 1) / bk;
  lo = 0;
  hi = n_kv;
  if (causal) {
    const int q_last = min(q0 + bq, Sq) - 1 + q_offset;
    hi = min(n_kv, q_last / bk + 1);
  }
  if (window > 0) {
    const int first_key = q0 + q_offset - window + 1;
    if (first_key > 0) lo = first_key / bk;
  }
}

// Query rows [qlo, qhi) that see some key of the tile [k0, k0 + bk):
// kv_range turned around (from k0 - q_offset under a causal mask, to
// k0 + bk - 1 + window - q_offset under a window).
__device__ __forceinline__ void q_range(int Sq, int causal, int window,
                                        int q_offset, int k0, int bk,
                                        int& qlo, int& qhi) {
  qlo = causal ? max(0, k0 - q_offset) : 0;
  qhi = Sq;
  if (window > 0)
    qhi = static_cast<int>(min(static_cast<long long>(Sq),
                               static_cast<long long>(k0) + bk - 1 + window -
                                   q_offset));
}

// Four consecutive elements as fp32: one 16-byte load of fp32, one 8-byte
// load of bf16 (rows are 16-byte aligned and a thread's four elements
// start at a multiple of 4).
__device__ __forceinline__ float4 load4(const float* ptr) {
  return *reinterpret_cast<const float4*>(ptr);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* ptr) {
  const uint2 u = *reinterpret_cast<const uint2*>(ptr);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* ptr, float4 x) {
  *reinterpret_cast<float4*>(ptr) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* ptr, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(ptr) = u;
}

// Sum of x over the `tpr` adjacent lanes that hold one row (tpr a power of
// two dividing 32).
template <int TPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < TPR; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace flash
