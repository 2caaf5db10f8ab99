// AdamW and its global-norm clipping as multi-tensor kernels for Hopper
// (sm_90a), bound to Python with ctypes (`kernels/adamw.py`).
//
// Replaces the update of `adamw_update` (src/repro/optim/optimizer.py:69)
// and `global_norm` (:51), which XLA fuses on the TPU into a few loops over
// the parameters.  In eager PyTorch the same loop walks the leaves one by
// one: ~15 elementwise fp32 kernels a leaf, and `square` and `sum` a leaf
// for each norm, each reading and writing whole fp32 tensors again.
//
// Bound: bytes.  The update reads p, g, m and v and writes p, m and v: 28 B
// an fp32 parameter; the norm reads g once more, 4 B.  MiniCPM-2B's
// 2,724,880,896 fp32 parameters: 76.3 GB + 10.9 GB, 26.0 ms at 3.35 TB/s.
// The arithmetic (two IEEE divisions and a square root an element) is far
// below the fp32 rate.
//
// Design:
//  * A leaf table instead of a launch a leaf.  The wrapper cuts the leaves,
//    grouped by (param dtype, grad dtype), into launches of at most
//    kMaxLeaves leaves (kMaxNormLeaves for the norm); each launch gets its
//    leaves' pointers, lengths and first chunks as a __grid_constant__
//    struct under 4 KB, so the kernel indexes it in parameter space with no
//    copy to local memory.  A leaf is cut into chunks of kChunk elements; a
//    block walks chunks blockIdx.x, + gridDim.x, ... and finds each chunk's
//    leaf by a binary search over the first chunks.
//  * Where a leaf's pointers allow (16 bytes for fp32, 8 for bf16), four
//    elements a thread a step through one vector load of each of p, g, m
//    and v; the last n % 4 elements, and every element of a leaf whose
//    pointers do not allow it, one at a time.
//  * The norm in two passes, no atomics: pass 1 runs kNormBlocks blocks a
//    launch whatever the device, each summing g^2 of its chunks in fp64 and
//    writing one fp32 partial; pass 2, one block, sums the partials in a
//    fixed order and writes the norm and the clip scale min(clip / (norm +
//    1e-9), 1) to a device buffer.  The same inputs give the same bits.
//  * The update reads the scale from that buffer: no host sync.  It does
//    the loop's fp32 arithmetic in the loop's order with IEEE rounding at
//    every step (__f*_rn: no contraction into FMAs, no fast math):
//        g = g * scale
//        m = b1 m + (1 - b1) g,  v = b2 v + ((1 - b2) g) g
//        d = (m / b1c) / (sqrt(v / b2c) + eps)  [+ wd p where decayed]
//        p = p - lr d, stored in p's dtype (bf16 rounded to nearest even).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstring>

namespace {

constexpr int kChunk = 1 << 14;      // elements a chunk; a multiple of 4
constexpr int kMaxLeaves = 64;       // leaves an update launch
constexpr int kMaxNormLeaves = 192;  // leaves a norm launch (pass 1)
constexpr int kNormBlocks = 1024;    // blocks a norm launch, fixed
constexpr int kThreads = 256;
constexpr int kFinalThreads = 1024;

enum Kind { kF32 = 0, kBF16 = 1 };
enum Flag { kDecay = 1, kVector = 2 };
enum Error { kErrTable = -1, kErrKind = -2 };

// One leaf as the wrapper packs it (numpy's UPDATE_ROW / NORM_ROW);
// chunk0 is the leaf's first chunk within its launch.
struct UpdateRow {
  unsigned long long p, g, m, v;
  long long n;
  int chunk0, flags;
};
struct NormRow {
  unsigned long long g;
  long long n;
  int chunk0, flags;
};
static_assert(sizeof(UpdateRow) == 48, "UpdateRow layout");
static_assert(sizeof(NormRow) == 24, "NormRow layout");

struct UpdateTable {
  void* p[kMaxLeaves];
  const void* g[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  long long n[kMaxLeaves];
  int chunk0[kMaxLeaves + 1];   // chunk0[count]: the launch's chunks
  unsigned char flags[kMaxLeaves];
  int count;
};

struct NormTable {
  const void* g[kMaxNormLeaves];
  long long n[kMaxNormLeaves];
  int chunk0[kMaxNormLeaves + 1];
  unsigned char flags[kMaxNormLeaves];
  int count;
};

struct Hyper {
  float lr, b1, omb1, b2, omb2, eps, wd, b1c, b2c;
};

// a launch's parameters stay within the classic 4 KB limit
static_assert(sizeof(UpdateTable) + sizeof(Hyper) + sizeof(void*) <= 4096,
              "update launch parameters over 4 KB");
static_assert(sizeof(NormTable) + sizeof(void*) <= 4096,
              "norm launch parameters over 4 KB");

template <typename T>
struct Io;

template <>
struct Io<float> {
  __device__ static void load4(const float* p, float x[4]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  }
  __device__ static void store4(float* p, const float x[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
  __device__ static float load1(const float* p) { return *p; }
  __device__ static void store1(float* p, float x) { *p = x; }
};

template <>
struct Io<__nv_bfloat16> {
  __device__ static void load4(const __nv_bfloat16* p, float x[4]) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    __nv_bfloat162 lo, hi;
    memcpy(&lo, &a.x, 4);
    memcpy(&hi, &a.y, 4);
    const float2 l = __bfloat1622float2(lo), h = __bfloat1622float2(hi);
    x[0] = l.x; x[1] = l.y; x[2] = h.x; x[3] = h.y;
  }
  __device__ static void store4(__nv_bfloat16* p, const float x[4]) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
    uint2 a;
    memcpy(&a.x, &lo, 4);
    memcpy(&a.y, &hi, 4);
    *reinterpret_cast<uint2*>(p) = a;
  }
  __device__ static float load1(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static void store1(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
};

// the largest i < count with chunk0[i] <= c (chunk0 rises strictly)
__device__ __forceinline__ int find_leaf(const int* chunk0, int count,
                                         int c) {
  int lo = 0, hi = count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (chunk0[mid] <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ void step(float& p, float g, float& m, float& v,
                                     float scale, const Hyper& h,
                                     bool decay) {
  g = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(h.omb2, g), g));
  float d = __fdiv_rn(__fdiv_rn(m, h.b1c),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.b2c)), h.eps));
  if (decay) d = __fadd_rn(d, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, d));
}

template <typename P, typename G>
__global__ void __launch_bounds__(kThreads)
adamw_kernel(const __grid_constant__ UpdateTable t, const Hyper h,
             const float* __restrict__ scale_ptr) {
  const float scale = *scale_ptr;
  const int total = t.chunk0[t.count];
  for (int c = blockIdx.x; c < total; c += gridDim.x) {
    const int leaf = find_leaf(t.chunk0, t.count, c);
    const long long off = (long long)(c - t.chunk0[leaf]) * kChunk;
    const long long end = min(off + kChunk, t.n[leaf]);
    P* p = static_cast<P*>(t.p[leaf]);
    const G* g = static_cast<const G*>(t.g[leaf]);
    float* m = t.m[leaf];
    float* v = t.v[leaf];
    const bool decay = t.flags[leaf] & kDecay;
    long long tail = off;
    if (t.flags[leaf] & kVector) {
      tail = off + ((end - off) & ~3LL);
      for (long long i = off + 4LL * threadIdx.x; i < tail;
           i += 4LL * kThreads) {
        float pp[4], gg[4], mm[4], vv[4];
        Io<P>::load4(p + i, pp);
        Io<G>::load4(g + i, gg);
        Io<float>::load4(m + i, mm);
        Io<float>::load4(v + i, vv);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          step(pp[k], gg[k], mm[k], vv[k], scale, h, decay);
        Io<P>::store4(p + i, pp);
        Io<float>::store4(m + i, mm);
        Io<float>::store4(v + i, vv);
      }
    }
    for (long long i = tail + threadIdx.x; i < end; i += kThreads) {
      float pp = Io<P>::load1(p + i), mm = m[i], vv = v[i];
      step(pp, Io<G>::load1(g + i), mm, vv, scale, h, decay);
      Io<P>::store1(p + i, pp);
      m[i] = mm;
      v[i] = vv;
    }
  }
}

// thread 0 gets the block's sum; the order is fixed by the block's shape
__device__ double block_sum(double s) {
  __shared__ double warp_sums[32];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  s = 0.0;
  if (warp == 0) {
    if (lane < (int)(blockDim.x >> 5)) s = warp_sums[lane];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  }
  return s;
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
norm_partial_kernel(const __grid_constant__ NormTable t,
                    float* __restrict__ partial) {
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  const int total = t.chunk0[t.count];
  for (int c = blockIdx.x; c < total; c += gridDim.x) {
    const int leaf = find_leaf(t.chunk0, t.count, c);
    const long long off = (long long)(c - t.chunk0[leaf]) * kChunk;
    const long long end = min(off + kChunk, t.n[leaf]);
    const G* g = static_cast<const G*>(t.g[leaf]);
    long long tail = off;
    if (t.flags[leaf] & kVector) {
      tail = off + ((end - off) & ~3LL);
      for (long long i = off + 4LL * threadIdx.x; i < tail;
           i += 4LL * kThreads) {
        float x[4];
        Io<G>::load4(g + i, x);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          acc[k] = fma((double)x[k], (double)x[k], acc[k]);
      }
    }
    for (long long i = tail + threadIdx.x; i < end; i += kThreads) {
      const double x = Io<G>::load1(g + i);
      acc[0] = fma(x, x, acc[0]);
    }
  }
  const double s = block_sum((acc[0] + acc[1]) + (acc[2] + acc[3]));
  if (threadIdx.x == 0) partial[blockIdx.x] = (float)s;
}

__global__ void __launch_bounds__(kFinalThreads)
norm_final_kernel(const float* __restrict__ partial, int count, float clip,
                  float* __restrict__ out) {
  double s = 0.0;
  for (int i = threadIdx.x; i < count; i += blockDim.x) s += partial[i];
  s = block_sum(s);
  if (threadIdx.x == 0) {
    const float norm = (float)sqrt(s);
    const float scale = __fdiv_rn(clip, __fadd_rn(norm, 1e-9f));
    out[0] = norm;
    out[1] = scale > 1.0f ? 1.0f : scale;   // a NaN stays NaN, as clamp
  }
}

long long chunks(long long n) { return (n + kChunk - 1) / kChunk; }

// The launch's chunk starts must rise from 0 by each leaf's chunks, every
// leaf non-empty; returns the launch's chunks, or -1.
template <typename Row>
long long check_rows(const Row* rows, int count, int max_count) {
  if (count < 1 || count > max_count) return -1;
  long long c = 0;
  for (int i = 0; i < count; ++i) {
    if (rows[i].n < 1 || rows[i].chunk0 != c) return -1;
    c += chunks(rows[i].n);
  }
  return c < (1LL << 31) ? c : -1;
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

template <typename P, typename G>
int launch_update(const UpdateRow* rows, int count, const Hyper& h,
                  const float* scale, cudaStream_t stream) {
  const long long total = check_rows(rows, count, kMaxLeaves);
  if (total < 0) return kErrTable;
  UpdateTable t;
  for (int i = 0; i < count; ++i) {
    t.p[i] = reinterpret_cast<void*>(rows[i].p);
    t.g[i] = reinterpret_cast<const void*>(rows[i].g);
    t.m[i] = reinterpret_cast<float*>(rows[i].m);
    t.v[i] = reinterpret_cast<float*>(rows[i].v);
    t.n[i] = rows[i].n;
    t.chunk0[i] = rows[i].chunk0;
    t.flags[i] = (unsigned char)rows[i].flags;
  }
  t.chunk0[count] = (int)total;
  t.count = count;
  static int per_sm = 0;   // resident blocks an SM, of this instantiation
  if (per_sm == 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                  adamw_kernel<P, G>,
                                                  kThreads, 0);
  const long long grid =
      std::min(total, (long long)std::max(per_sm, 1) * sm_count());
  adamw_kernel<P, G><<<(int)grid, kThreads, 0, stream>>>(t, h, scale);
  return (int)cudaGetLastError();
}

template <typename G>
int launch_norm(const NormRow* rows, int count, float* partial,
                cudaStream_t stream) {
  const long long total = check_rows(rows, count, kMaxNormLeaves);
  if (total < 0) return kErrTable;
  NormTable t;
  for (int i = 0; i < count; ++i) {
    t.g[i] = reinterpret_cast<const void*>(rows[i].g);
    t.n[i] = rows[i].n;
    t.chunk0[i] = rows[i].chunk0;
    t.flags[i] = (unsigned char)rows[i].flags;
  }
  t.chunk0[count] = (int)total;
  t.count = count;
  norm_partial_kernel<G><<<kNormBlocks, kThreads, 0, stream>>>(t, partial);
  return (int)cudaGetLastError();
}

}  // namespace

// out: kChunk, kMaxLeaves, kMaxNormLeaves, kNormBlocks (the wrapper's
// CHUNK, MAX_LEAVES, MAX_NORM_LEAVES and NORM_BLOCKS must equal them)
extern "C" int adamw_constants(int* out) {
  out[0] = kChunk;
  out[1] = kMaxLeaves;
  out[2] = kMaxNormLeaves;
  out[3] = kNormBlocks;
  return 0;
}

// table: NormRows, the leaves of every launch in turn; launches: 3 ints a
// launch (first row, rows, grad kind).  partial: n_launches x kNormBlocks
// floats of scratch; out: 2 floats, the norm and the clip scale.
// (The row types live in the anonymous namespace: the entry points take
// void pointers, or the compiler would not export them.)
extern "C" int adamw_norm(const void* table, const int* launches,
                          int n_launches, float clip, float* partial,
                          float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const NormRow* rows = static_cast<const NormRow*>(table);
  for (int l = 0; l < n_launches; ++l) {
    const int* a = launches + 3 * l;
    float* part = partial + (long long)l * kNormBlocks;
    int err;
    if (a[2] == kF32) err = launch_norm<float>(rows + a[0], a[1], part, s);
    else if (a[2] == kBF16)
      err = launch_norm<__nv_bfloat16>(rows + a[0], a[1], part, s);
    else err = kErrKind;
    if (err) return err;
  }
  norm_final_kernel<<<1, kFinalThreads, 0, s>>>(
      partial, n_launches * kNormBlocks, clip, out);
  return (int)cudaGetLastError();
}

// table: UpdateRows, every launch's; launches: 4 ints a launch (first row,
// rows, param kind, grad kind).  scale: the clip scale on the device
// (adamw_norm's out + 1).  omb1, omb2: 1 - b1 and 1 - b2 as the caller
// rounds them.
extern "C" int adamw_update(const void* table, const int* launches,
                            int n_launches, float lr, float b1, float omb1,
                            float b2, float omb2, float eps, float wd,
                            float b1c, float b2c, const float* scale,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const UpdateRow* rows = static_cast<const UpdateRow*>(table);
  const Hyper h{lr, b1, omb1, b2, omb2, eps, wd, b1c, b2c};
  for (int l = 0; l < n_launches; ++l) {
    const int* a = launches + 4 * l;
    const UpdateRow* r = rows + a[0];
    const bool known = ((a[2] | a[3]) & ~1) == 0;   // kF32 or kBF16 each
    int err;
    switch (known ? 2 * a[2] + a[3] : -1) {
      case 2 * kF32 + kF32:
        err = launch_update<float, float>(r, a[1], h, scale, s); break;
      case 2 * kF32 + kBF16:
        err = launch_update<float, __nv_bfloat16>(r, a[1], h, scale, s);
        break;
      case 2 * kBF16 + kF32:
        err = launch_update<__nv_bfloat16, float>(r, a[1], h, scale, s);
        break;
      case 2 * kBF16 + kBF16:
        err = launch_update<__nv_bfloat16, __nv_bfloat16>(r, a[1], h, scale,
                                                          s);
        break;
      default: err = kErrKind;
    }
    if (err) return err;
  }
  return 0;
}

extern "C" const char* adamw_error_string(int err) {
  if (err == kErrTable)
    return "a malformed leaf table (leaves a launch, chunk starts, lengths)";
  if (err == kErrKind) return "a dtype the kernels do not take";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
