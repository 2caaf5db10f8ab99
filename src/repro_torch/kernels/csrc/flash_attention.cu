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
// bf16) on an H100 SXM: the causal half of QK^T and PV is
// 2*B*H*S^2*hd ~ 68.7 GFLOP, ~69 us at 989 TFLOP/s; q, k, v and o are
// ~134 MB, ~40 us at 3.35 TB/s.  So the call is bound by tensor-core
// operations at ~69 us, ~1.5 ms per 22-layer prefill.
//
// Design (simple and exact first; no TMA / wgmma yet):
//  * bf16: one block of 4 warps per (b*h, 64-row q tile).  Each warp owns
//    16 q rows, keeps its Q fragments in registers, and walks 64-key K/V
//    tiles staged through shared memory (K row-major, V transposed) with
//    mma.sync m16n8k16 (bf16 in, fp32 accumulate).  The softmax runs on
//    the fp32 accumulator fragments; P is rounded to bf16 only as the A
//    operand of P @ V.  Shared-memory rows are padded by 8 elements so the
//    fragment loads of a warp hit 32 distinct banks.
//  * fp32: the tensor cores would round to tf32, so a SIMT kernel: four
//    threads per q row, each holding a quarter of q and acc in registers,
//    over 32-key K/V tiles in shared memory that a warp reads by broadcast.
//  * KV tiles that are masked for every row of the q tile are skipped
//    (past the diagonal when causal, before the window when windowed);
//    the heaviest causal q tiles are scheduled first.
//  * Keys past Skv get p = 0; rows past Sq are computed and not stored.
// Masked logits are -1e30, as in the plain version, so a row gives the
// same result as long as it sees at least one key.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;  // element strides; head_dim is contiguous
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  Strides sq, sk, sv, so;
  int H, Sq, Skv;
  int causal, window, q_offset;  // window <= 0: none
  float scale;
};

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  return kpos < p.Skv && (!p.causal || qpos >= kpos) &&
         (p.window <= 0 || qpos - kpos < p.window);
}

// KV tiles [lo, hi) that hold a visible key for some row of q tile [q0, q0+bq).
__device__ __forceinline__ void kv_range(const Params& p, int q0, int bq,
                                         int bk, int& lo, int& hi) {
  const int n_kv = (p.Skv + bk - 1) / bk;
  lo = 0;
  hi = n_kv;
  if (p.causal) {
    const int q_last = min(q0 + bq, p.Sq) - 1 + p.q_offset;
    hi = min(n_kv, q_last / bk + 1);
  }
  if (p.window > 0) {
    const int first_key = q0 + p.q_offset - p.window + 1;
    if (first_key > 0) lo = first_key / bk;
  }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;       // q rows per block (16 per warp)
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 128;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

union Pack8 {
  uint4 u;
  uint16_t h[8];  // bf16 bit patterns
};

// rows [row0, row0+ROWS) of one (b, h) slice -> sm[r*LD + d]; zero past n.
template <int HD, int ROWS, int LD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* sm,
                                          const __nv_bfloat16* base,
                                          long long stride_s, int row0,
                                          int n) {
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      val = *reinterpret_cast<const uint4*>(base + (row0 + r) * stride_s +
                                            cc * 8);
    *reinterpret_cast<uint4*>(sm + r * LD + cc * 8) = val;
  }
}

// as load_rows, stored transposed: smT[d*LDT + r].
template <int HD, int ROWS, int LDT>
__device__ __forceinline__ void load_rows_t(__nv_bfloat16* smT,
                                            const __nv_bfloat16* base,
                                            long long stride_s, int row0,
                                            int n) {
  constexpr int kChunks = HD / 8;
  for (int c = threadIdx.x; c < ROWS * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    Pack8 val;
    val.u = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n)
      val.u = *reinterpret_cast<const uint4*>(base + (row0 + r) * stride_s +
                                              cc * 8);
    uint16_t* dst = reinterpret_cast<uint16_t*>(smT);
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[(cc * 8 + e) * LDT + r] = val.h[e];
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16(const Params p) {
  constexpr int LD = HD + 8;     // Q / K row pitch
  constexpr int LDT = kBK + 8;   // V^T row pitch
  constexpr int KQ = HD / 16;    // k-steps of Q K^T
  constexpr int NS = kBK / 8;    // n-tiles of S
  constexpr int NO = HD / 8;     // n-tiles of O
  __shared__ __align__(16) __nv_bfloat16 sQK[kBQ * LD];  // Q, then K tiles
  __shared__ __align__(16) __nv_bfloat16 sVt[HD * LDT];

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8

  const auto* Q = static_cast<const __nv_bfloat16*>(p.q) + b * p.sq.b + h * p.sq.h;
  const auto* K = static_cast<const __nv_bfloat16*>(p.k) + b * p.sk.b + h * p.sk.h;
  const auto* V = static_cast<const __nv_bfloat16*>(p.v) + b * p.sv.b + h * p.sv.h;
  auto* O = static_cast<__nv_bfloat16*>(p.o) + b * p.so.b + h * p.so.h;

  load_rows<HD, kBQ, LD>(sQK, Q, p.sq.s, q0, p.Sq);
  __syncthreads();
  uint32_t qf[KQ][4];
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) {
    qf[kk][0] = ld32(&sQK[r0 * LD + kk * 16 + 2 * t]);
    qf[kk][1] = ld32(&sQK[(r0 + 8) * LD + kk * 16 + 2 * t]);
    qf[kk][2] = ld32(&sQK[r0 * LD + kk * 16 + 8 + 2 * t]);
    qf[kk][3] = ld32(&sQK[(r0 + 8) * LD + kk * 16 + 8 + 2 * t]);
  }
  __syncthreads();  // sQK now holds K tiles

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float scale_log2 = p.scale * kLog2e;  // softmax in base 2
  const int qpos[2] = {q0 + r0 + p.q_offset, q0 + r0 + 8 + p.q_offset};

  int lo, hi;
  kv_range(p, q0, kBQ, kBK, lo, hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kBK;
    load_rows<HD, kBK, LD>(sQK, K, p.sk.s, k0, p.Skv);
    load_rows_t<HD, kBK, LDT>(sVt, V, p.sv.s, k0, p.Skv);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* krow = &sQK[(8 * j + g) * LD + 2 * t];
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk)
        mma_bf16(s[j], qf[kk], ld32(krow + kk * 16), ld32(krow + kk * 16 + 8));
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * j + 2 * t + (e & 1);
        const float x = visible(p, qpos[e >> 1], kpos) ? s[j][e] * scale_log2
                                                       : kNegInf;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // a row lives on the 4 lanes of a quad
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];  // per-lane partial sum; quad-reduced at the end
    }
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * j + 2 * t + (e & 1);
        const float pe = kpos < p.Skv ? exp2f(s[j][e] - m[e >> 1]) : 0.f;
        s[j][e] = pe;
        l[e >> 1] += pe;
      }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
    // P's accumulator fragments are the A fragments of P @ V.
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* vrow = &sVt[(8 * n + g) * LDT + kk * 16 + 2 * t];
        mma_bf16(o[n], a, ld32(vrow), ld32(vrow + 8));
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = q0 + r0 + 8 * r;
    if (row >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = O + row * p.so.s + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(orow + 8 * n) =
          pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// fp32: SIMT kernel
// ---------------------------------------------------------------------------

constexpr int kFBQ = 64;        // q rows per block, 4 threads per row
constexpr int kFBK = 32;        // keys per tile
constexpr int kFThreads = 256;
constexpr int kFChunk = 8;      // keys per online-softmax update

template <int HD>
__global__ void __launch_bounds__(kFThreads)
    flash_fwd_f32(const Params p) {
  constexpr int DPT = HD / 4;   // dims per thread: {16i + 4t + e}
  __shared__ __align__(16) float sK[kFBK * HD];
  __shared__ __align__(16) float sV[kFBK * HD];

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFBQ;
  const int t = threadIdx.x % 4;
  const int qi = q0 + threadIdx.x / 4;
  const int qpos = qi + p.q_offset;

  const float* Q = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
  const float* K = static_cast<const float*>(p.k) + b * p.sk.b + h * p.sk.h;
  const float* V = static_cast<const float*>(p.v) + b * p.sv.b + h * p.sv.h;
  float* O = static_cast<float*>(p.o) + b * p.so.b + h * p.so.h;

  float q[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < HD / 16; ++i) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qi < p.Sq)
      x = *reinterpret_cast<const float4*>(Q + qi * p.sq.s + 16 * i + 4 * t);
    q[4 * i + 0] = x.x * p.scale;  // (q * scale) . k, as the plain version
    q[4 * i + 1] = x.y * p.scale;
    q[4 * i + 2] = x.z * p.scale;
    q[4 * i + 3] = x.w * p.scale;
  }
#pragma unroll
  for (int d = 0; d < DPT; ++d) acc[d] = 0.f;
  float m = kNegInf, l = 0.f;

  int lo, hi;
  kv_range(p, q0, kFBQ, kFBK, lo, hi);
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kFBK;
    for (int c = threadIdx.x; c < kFBK * HD / 4; c += kFThreads) {
      const int r = c / (HD / 4), cc = c % (HD / 4);
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (k0 + r < p.Skv) {
        kx = *reinterpret_cast<const float4*>(K + (k0 + r) * p.sk.s + 4 * cc);
        vx = *reinterpret_cast<const float4*>(V + (k0 + r) * p.sv.s + 4 * cc);
      }
      *reinterpret_cast<float4*>(&sK[r * HD + 4 * cc]) = kx;
      *reinterpret_cast<float4*>(&sV[r * HD + 4 * cc]) = vx;
    }
    __syncthreads();

    for (int j0 = 0; j0 < kFBK; j0 += kFChunk) {
      float s[kFChunk];
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < kFChunk; ++jj) {
        const float* krow = &sK[(j0 + jj) * HD + 4 * t];
        float d = 0.f;
#pragma unroll
        for (int i = 0; i < HD / 16; ++i) {
          const float4 kv = *reinterpret_cast<const float4*>(krow + 16 * i);
          d = fmaf(q[4 * i + 0], kv.x, d);
          d = fmaf(q[4 * i + 1], kv.y, d);
          d = fmaf(q[4 * i + 2], kv.z, d);
          d = fmaf(q[4 * i + 3], kv.w, d);
        }
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        s[jj] = visible(p, qpos, k0 + j0 + jj) ? d : kNegInf;
        mx = fmaxf(mx, s[jj]);
      }
      const float corr = expf(m - mx);
      m = mx;
      l *= corr;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < kFChunk; ++jj) {
        const float pe = k0 + j0 + jj < p.Skv ? expf(s[jj] - m) : 0.f;
        l += pe;
        const float* vrow = &sV[(j0 + jj) * HD + 4 * t];
#pragma unroll
        for (int i = 0; i < HD / 16; ++i) {
          const float4 vv = *reinterpret_cast<const float4*>(vrow + 16 * i);
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
    for (int i = 0; i < HD / 16; ++i)
      *reinterpret_cast<float4*>(O + qi * p.so.s + 16 * i + 4 * t) =
          make_float4(acc[4 * i] * inv, acc[4 * i + 1] * inv,
                      acc[4 * i + 2] * inv, acc[4 * i + 3] * inv);
  }
}

template <int HD>
void launch(const Params& p, int dtype, int bh, cudaStream_t stream) {
  if (dtype == 1) {
    dim3 grid(bh, (p.Sq + kBQ - 1) / kBQ);
    flash_fwd_bf16<HD><<<grid, kThreads, 0, stream>>>(p);
  } else {
    dim3 grid(bh, (p.Sq + kFBQ - 1) / kFBQ);
    flash_fwd_f32<HD><<<grid, kFThreads, 0, stream>>>(p);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, as
// (batch, seq, head); the head_dim stride must be 1.  window <= 0 means
// no window.  Returns cudaGetLastError() after the launch (0 = success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int Sq, int Skv, int hd, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, int causal, int window, int q_offset,
    float scale, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
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
  if ((dtype != 0 && dtype != 1) || (hd != 64 && hd != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    launch<64>(p, dtype, B * H, st);
  else
    launch<128>(p, dtype, B * H, st);
  return (int)cudaGetLastError();
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
