// Fused optimizer updates for Hopper (sm_90a), hand-written CUDA C++: the
// multi-tensor Adam/AdamW update and the two fused-LAMB passes.
//
// --- Adam / AdamW ---------------------------------------------------------
// Replaces the TPU kernel `_adam_kernel` of
// mxnet_tpu/pallas_ops/fused_update.py:86 (launched at :144 by
// `adam_update`, which `FunctionalOptimizer.apply` calls per parameter).
// One pass per element, in place (the TPU kernel aliased w, m, v to its
// outputs):
//   g = clip(g * rescale) [+ wd w  (Adam: decay folded into the gradient)]
//   m = b1 m + (1-b1) g;  v = b2 v + (1-b2) g^2
//   step = lr_t m / (sqrt(v) + eps)   [AdamW: eta (step + wd w)]
//   w = w - step   (rounded once to w's dtype)
// lr_t carries the bias correction (computed on the host, per tensor).
// Every product and sum is an explicit round-to-nearest intrinsic, so nvcc
// contracts nothing into an FMA and the arithmetic is the plain version's,
// operation for operation.
//
// What bounds it: bytes. With a bf16 weight it reads w, g (2 B each), m, v
// (4 B) and writes w, m, v: 22 B an element (28 B with a float32 weight)
// against ~15 operations, far below the card's float32 rate.
//
// One launch updates a whole LIST of tensors of one weight dtype: a step
// of a model is one launch (two where float32 and bf16 weights mix), not
// one a parameter. A launch per tensor paid, for every tensor, the host's
// wrapper and launch (tens of microseconds against a few for a LayerNorm
// vector's bytes) and, on the card, a grid of its own whose last wave ran
// part-empty. Here the table of tensors (pointers, element count, lr_t and
// wd of each) travels in the kernel's parameter space (CUDA 12.1 allows
// 32,764 bytes on sm_70 and later: ADAM_MAX_TENSORS entries; a longer list
// is cut into as few launches as fit), so no copy precedes the launch. The
// grid is persistent, about as many blocks as the SMs hold at once, and
// walks ADAM_CHUNK-element chunks of the concatenated list: a block finds
// the tensor of its chunk by a binary search of the per-tensor chunk
// prefix counts, staged once into shared memory. Inside a chunk each
// thread takes 4 neighbouring elements with one vector load per array
// (8 B for bf16, 16 B for float32; every pointer starts on a 16-byte
// boundary, which the C entry checks); a tensor's last n % 4 elements go
// one at a time.
//
// --- LAMB -----------------------------------------------------------------
// Replaces the TPU kernels `_lamb1_kernel` and `_lamb2_kernel` of
// mxnet_tpu/pallas_ops/fused_update.py (launched by `lamb_pass1` /
// `lamb_pass2` from `FusedLamb._apply_flat_pallas`). The master weights W,
// gradient G and moments m, v are (R, 512) float32 row views of flat
// vectors in which every parameter is a whole range of rows:
//   pass 1: g = clip(G * rescale); m = b1 m + (1-b1) g; v = b2 v + (1-b2) g^2
//           (written in place); u = m/c1 / (sqrt(v/c2) + eps) + wd_row W;
//           per-row sum(W^2) and sum(u^2) for the trust-ratio norms
//   pass 2: u recomputed from the stored m, v;  W -= lr * trust_row * u
//           (in place)
// The per-segment norms and the trust ratio between the passes are a few
// hundred elements and stay in plain torch. Recomputing u in pass 2 instead
// of storing it is the TPU design too: arithmetic is free here, a full-size
// temporary is not.
//
// The moments are stored as float32 or as bf16 (the `lamb_moments_dtype`
// knob; the TPU kernels' `moments_f32=False`). The kernels are templated on
// the moment type MT; the arithmetic is float32 either way and the float32
// instantiation is the code the port had before bf16 storage. With bf16,
// pass 1 widens m and v, runs the EMAs in float32, each operation rounded
// as the plain version rounds it, rounds each new moment to bf16 (nearest
// even) and widens it back BEFORE the update u and the row sums of u^2, so
// the trust ratio sees what is stored; then it stores the bf16 moments in
// place: bit for bit the plain version's. Pass 2 reads the bf16 moments.
// The TPU kernel pads the rows to 16 for bf16's (16, 128) tiles; the flat
// layout here needs no padding: a lane reads its 4 moments as one 8-byte
// vector.
//
// What bounds it: bytes. Pass 1 reads W, G, m, v and writes m, v: 24 B an
// element with float32 moments, 16 B with bf16; pass 2 reads W, m, v and
// writes W: 16 B, or 12 B. Against 7 and 4 operations that is far below
// the ~20 operations per byte where the card's float32 rate would bind.
// One warp owns one 512-lane row (16 elements a lane, float4 loads of W
// and G, float4 or 8-byte bf16 loads of m and v), so a row's sums are a
// warp shuffle reduction with no cross-block pass.
#include <type_traits>

#include "common.cuh"

namespace mxt {
namespace {

constexpr int LANES = 512;            // row width of the flat layout
constexpr int ROWS_PER_BLOCK = 8;     // one warp per row

struct LambArgs {
  float b1, omb1, b2, omb2;           // beta1, 1 - beta1, beta2, 1 - beta2
  float eps, rescale, clip;           // clip <= 0: no clipping
  float c1, c2;                       // bias-correction denominators
  int bias_correction;
};

__device__ __forceinline__ float lamb_update(const LambArgs& a, float m,
                                             float v, float w, float wd) {
  const float mh = a.bias_correction ? m / a.c1 : m;
  const float vh = a.bias_correction ? v / a.c2 : v;
  return mh / (sqrtf(vh) + a.eps) + wd * w;
}

// the 4 moments of a lane as float4: one 16-byte load (float32 storage)
// or one 8-byte load of 4 bf16, widened (bf16 storage); and the store
template <typename MT> __device__ __forceinline__ float4 load4(const MT* p);
template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename MT>
__device__ __forceinline__ void store4(MT* p, float4 f);
template <>
__device__ __forceinline__ void store4<float>(float* p, float4 f) {
  *reinterpret_cast<float4*>(p) = f;
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float4 f) {
  uint2 u;
  u.x = pack_bf16(f.x, f.y);
  u.y = pack_bf16(f.z, f.w);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename MT>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
lamb1_kernel(const float* __restrict__ W, const float* __restrict__ G,
             MT* __restrict__ M, MT* __restrict__ V,
             const float* __restrict__ wd_rows, float* __restrict__ rw,
             float* __restrict__ ru, int R, LambArgs a) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= R) return;
  const float wd = wd_rows[row];
  const size_t base = (size_t)row * LANES;
  float sw = 0.f, su = 0.f;
#pragma unroll
  for (int i = 0; i < LANES / 128; ++i) {
    const size_t idx = base + (size_t)(i * 32 + lane) * 4;
    const float4 w4 = *reinterpret_cast<const float4*>(W + idx);
    const float4 g4 = *reinterpret_cast<const float4*>(G + idx);
    float4 m4 = load4<MT>(M + idx);
    float4 v4 = load4<MT>(V + idx);
    const float w[4] = {w4.x, w4.y, w4.z, w4.w};
    const float gi[4] = {g4.x, g4.y, g4.z, g4.w};
    float m[4] = {m4.x, m4.y, m4.z, m4.w};
    float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float g = gi[e] * a.rescale;
      if (a.clip > 0.f) g = fminf(fmaxf(g, -a.clip), a.clip);
      if (std::is_same<MT, float>::value) {
        m[e] = a.b1 * m[e] + a.omb1 * g;
        v[e] = a.b2 * v[e] + a.omb2 * (g * g);
      } else {
        // reduced-precision storage: the EMA rounded operation by
        // operation (no FMA: where its two terms nearly cancel, a
        // contraction moves the float32 value by many bf16 ulps of the
        // result), then rounded to the storage type; the update and the
        // norms see the stored moments
        m[e] = to_f<MT>(from_f<MT>(__fadd_rn(__fmul_rn(a.b1, m[e]),
                                             __fmul_rn(a.omb1, g))));
        v[e] = to_f<MT>(from_f<MT>(__fadd_rn(
            __fmul_rn(a.b2, v[e]), __fmul_rn(a.omb2, __fmul_rn(g, g)))));
      }
      const float u = lamb_update(a, m[e], v[e], w[e], wd);
      sw += w[e] * w[e];
      su += u * u;
    }
    store4<MT>(M + idx, make_float4(m[0], m[1], m[2], m[3]));
    store4<MT>(V + idx, make_float4(v[0], v[1], v[2], v[3]));
  }
  sw = warp_sum(sw);
  su = warp_sum(su);
  if (lane == 0) {
    rw[row] = sw;
    ru[row] = su;
  }
}

template <typename MT>
__global__ void __launch_bounds__(ROWS_PER_BLOCK * 32)
lamb2_kernel(float* __restrict__ W, const MT* __restrict__ M,
             const MT* __restrict__ V, const float* __restrict__ wd_rows,
             const float* __restrict__ trust_rows, int R, LambArgs a,
             float lr) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= R) return;
  const float wd = wd_rows[row];
  const float step = lr * trust_rows[row];
  const size_t base = (size_t)row * LANES;
#pragma unroll
  for (int i = 0; i < LANES / 128; ++i) {
    const size_t idx = base + (size_t)(i * 32 + lane) * 4;
    float4 w4 = *reinterpret_cast<const float4*>(W + idx);
    const float4 m4 = load4<MT>(M + idx);
    const float4 v4 = load4<MT>(V + idx);
    w4.x -= step * lamb_update(a, m4.x, v4.x, w4.x, wd);
    w4.y -= step * lamb_update(a, m4.y, v4.y, w4.y, wd);
    w4.z -= step * lamb_update(a, m4.z, v4.z, w4.z, wd);
    w4.w -= step * lamb_update(a, m4.w, v4.w, w4.w, wd);
    *reinterpret_cast<float4*>(W + idx) = w4;
  }
}

struct AdamArgs {
  float lr, b1, omb1, b2, omb2, eps, wd, rescale, clip, eta;  // clip <= 0: off
  int decoupled;                                             // 1: AdamW
};

__device__ __forceinline__ void adam_elem(const AdamArgs& a, float w, float g,
                                          float& m, float& v, float& w_out) {
  g = __fmul_rn(g, a.rescale);
  if (a.clip > 0.f) g = fminf(fmaxf(g, -a.clip), a.clip);
  if (!a.decoupled) g = __fadd_rn(g, __fmul_rn(a.wd, w));
  m = __fadd_rn(__fmul_rn(a.b1, m), __fmul_rn(a.omb1, g));
  v = __fadd_rn(__fmul_rn(a.b2, v), __fmul_rn(a.omb2, __fmul_rn(g, g)));
  float step = __fdiv_rn(__fmul_rn(a.lr, m), __fadd_rn(__fsqrt_rn(v), a.eps));
  if (a.decoupled) step = __fmul_rn(a.eta, __fadd_rn(step, __fmul_rn(a.wd, w)));
  w_out = __fsub_rn(w, step);
}

// 4 elements of T as one vector load/store (float: 16 B, bf16: 8 B)
template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<__nv_bfloat16> { using type = uint2; };

template <typename T>
__device__ __forceinline__ void unpack4(const typename Vec4<T>::type& u,
                                        float* f) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = to_f<T>(e[i]);
}

template <typename T>
__device__ __forceinline__ typename Vec4<T>::type pack4(const float* f) {
  typename Vec4<T>::type u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = from_f<T>(f[i]);
  return u;
}

constexpr int ADAM_THREADS = 256;
constexpr int ADAM_CHUNK = 4096;        // elements of one tensor a block takes
constexpr int ADAM_MAX_TENSORS = 600;   // entries of one launch's table
constexpr long long ADAM_MAX_CHUNKS = 1LL << 30;   // chunks of one launch

// One tensor of the list: the layout of the wrapper's numpy table (48 B).
struct AdamEntry {
  void* w;
  const void* g;
  float* m;
  float* v;
  long long n;                          // elements
  float lr, wd;                         // bias-corrected lr_t; weight decay
};
static_assert(sizeof(AdamEntry) == 48, "AdamEntry is the wrapper's table row");

// The kernel's parameter: up to ADAM_MAX_TENSORS non-empty tensors of one
// dtype, chunk_start[t] the first chunk of tensor t (chunk_start[count] the
// total), and the scalars the list shares.
struct AdamList {
  AdamEntry e[ADAM_MAX_TENSORS];
  int chunk_start[ADAM_MAX_TENSORS + 1];
  int count;
  float b1, omb1, b2, omb2, eps, rescale, clip, eta;   // clip <= 0: off
  int decoupled;                                      // 1: AdamW
};
static_assert(sizeof(AdamList) <= 32764, "kernel parameter space");

template <typename T>
__global__ void __launch_bounds__(ADAM_THREADS)
adam_kernel(const __grid_constant__ AdamList L) {
  __shared__ int start[ADAM_MAX_TENSORS + 1];
  for (int i = threadIdx.x; i <= L.count; i += ADAM_THREADS)
    start[i] = L.chunk_start[i];
  __syncthreads();
  const int total = start[L.count];
  int t = 0;
  for (int c = blockIdx.x; c < total; c += gridDim.x) {
    // the tensor of chunk c: the last t with start[t] <= c (a block's
    // chunks only grow, so the search starts at the previous tensor)
    int lo = t, hi = L.count - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (start[mid] <= c) lo = mid; else hi = mid - 1;
    }
    t = lo;
    const AdamEntry& e = L.e[t];
    const AdamArgs a{e.lr, L.b1, L.omb1, L.b2, L.omb2, L.eps, e.wd,
                     L.rescale, L.clip, L.eta, L.decoupled};
    T* __restrict__ W = static_cast<T*>(e.w);
    const T* __restrict__ G = static_cast<const T*>(e.g);
    float* __restrict__ M = e.m;
    float* __restrict__ V = e.v;
    const long long c0 = (long long)(c - start[t]) * ADAM_CHUNK;
    const long long c1 = c0 + ADAM_CHUNK < e.n ? c0 + ADAM_CHUNK : e.n;
    const long long vec_end = c0 + ((c1 - c0) & ~3LL);
    using VT = typename Vec4<T>::type;
    for (long long i0 = c0 + threadIdx.x * 4; i0 < vec_end;
         i0 += ADAM_THREADS * 4) {
      float w[4], g[4], wo[4];
      unpack4<T>(*reinterpret_cast<const VT*>(W + i0), w);
      unpack4<T>(*reinterpret_cast<const VT*>(G + i0), g);
      const float4 m4 = *reinterpret_cast<const float4*>(M + i0);
      const float4 v4 = *reinterpret_cast<const float4*>(V + i0);
      float m[4] = {m4.x, m4.y, m4.z, m4.w};
      float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) adam_elem(a, w[k], g[k], m[k], v[k], wo[k]);
      *reinterpret_cast<VT*>(W + i0) = pack4<T>(wo);
      *reinterpret_cast<float4*>(M + i0) = make_float4(m[0], m[1], m[2], m[3]);
      *reinterpret_cast<float4*>(V + i0) = make_float4(v[0], v[1], v[2], v[3]);
    }
    // the tensor's last n % 4 elements (only its last chunk has any)
    const long long i = vec_end + threadIdx.x;
    if (i < c1) {
      float m = M[i], v = V[i], wo;
      adam_elem(a, to_f<T>(W[i]), to_f<T>(G[i]), m, v, wo);
      W[i] = from_f<T>(wo);
      M[i] = m;
      V[i] = v;
    }
  }
}

// Launch the kernel over L (count >= 1) on a persistent grid: as many
// blocks as the card holds at once, fewer when the list has fewer chunks.
template <typename T>
cudaError_t launch_adam(const AdamList& L, cudaStream_t stream) {
  static int grid_cap = 0;
  if (grid_cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, adam_kernel<T>, ADAM_THREADS, 0);
    if (e != cudaSuccess) return e;
    grid_cap = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int total = L.chunk_start[L.count];
  adam_kernel<T><<<total < grid_cap ? total : grid_cap, ADAM_THREADS, 0,
                   stream>>>(L);
  return cudaGetLastError();
}

LambArgs make_args(float b1, float omb1, float b2, float omb2, float eps,
                   float rescale, float clip, float c1, float c2,
                   int bias_correction) {
  return LambArgs{b1, omb1, b2, omb2, eps, rescale, clip, c1, c2,
                  bias_correction};
}

}  // namespace
}  // namespace mxt

// W, G (R, 512) float32 contiguous; M, V (R, 512) contiguous, float32 when
// mdt is kF32, bf16 when kBF16; wd_rows, rw, ru (R,) float32. M and V are
// updated in place. Returns the CUDA error of the launch.
extern "C" int mx_lamb_pass1(const void* W, const void* G, void* M, void* V,
                             const void* wd_rows, void* rw, void* ru, int R,
                             float b1, float omb1, float b2, float omb2,
                             float eps, float rescale, float clip, float c1,
                             float c2, int bias_correction, int mdt,
                             void* stream) {
  using namespace mxt;
  if (R <= 0 || (mdt != kF32 && mdt != kBF16)) return cudaErrorInvalidValue;
  const LambArgs a =
      make_args(b1, omb1, b2, omb2, eps, rescale, clip, c1, c2, bias_correction);
  const int blocks = (R + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(W);
  const float* g = static_cast<const float*>(G);
  const float* wd = static_cast<const float*>(wd_rows);
  float* sw = static_cast<float*>(rw);
  float* su = static_cast<float*>(ru);
  if (mdt == kF32)
    lamb1_kernel<float><<<blocks, ROWS_PER_BLOCK * 32, 0, s>>>(
        w, g, static_cast<float*>(M), static_cast<float*>(V), wd, sw, su, R,
        a);
  else
    lamb1_kernel<__nv_bfloat16><<<blocks, ROWS_PER_BLOCK * 32, 0, s>>>(
        w, g, static_cast<__nv_bfloat16*>(M), static_cast<__nv_bfloat16*>(V),
        wd, sw, su, R, a);
  return cudaGetLastError();
}

// W (R, 512) float32, updated in place; M, V (R, 512) in the moment dtype
// mdt (kF32 or kBF16); wd_rows, trust_rows (R,) float32. Returns the CUDA
// error of the launch.
extern "C" int mx_lamb_pass2(void* W, const void* M, const void* V,
                             const void* wd_rows, const void* trust_rows,
                             int R, float eps, float c1, float c2,
                             int bias_correction, float lr, int mdt,
                             void* stream) {
  using namespace mxt;
  if (R <= 0 || (mdt != kF32 && mdt != kBF16)) return cudaErrorInvalidValue;
  const LambArgs a =
      make_args(0.f, 0.f, 0.f, 0.f, eps, 1.f, 0.f, c1, c2, bias_correction);
  const int blocks = (R + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(W);
  const float* wd = static_cast<const float*>(wd_rows);
  const float* tr = static_cast<const float*>(trust_rows);
  if (mdt == kF32)
    lamb2_kernel<float><<<blocks, ROWS_PER_BLOCK * 32, 0, s>>>(
        w, static_cast<const float*>(M), static_cast<const float*>(V), wd, tr,
        R, a, lr);
  else
    lamb2_kernel<__nv_bfloat16><<<blocks, ROWS_PER_BLOCK * 32, 0, s>>>(
        w, static_cast<const __nv_bfloat16*>(M),
        static_cast<const __nv_bfloat16*>(V), wd, tr, R, a, lr);
  return cudaGetLastError();
}

// Adam/AdamW over a list of `count` tensors, in place. `table` holds one
// AdamEntry per tensor (the wrapper's numpy rows), `dtypes` its weight's
// dtype code (kF32 or kBF16; g in w's dtype, m and v float32). Every entry
// is checked first: n >= 0, a known dtype, and w, g, m, v of a non-empty
// tensor on a 16-byte boundary; on the first that fails, *bad is its index,
// nothing launches and the return is cudaErrorInvalidValue. Then one launch
// for each dtype present (more only past ADAM_MAX_TENSORS tensors, or
// ADAM_MAX_CHUNKS chunks, of one dtype), empty tensors left out; *launched
// counts them. Returns the CUDA
// error of the first launch that failed, else 0.
extern "C" int mx_adam_update_multi(const void* table, const int* dtypes,
                                    int count, float b1, float omb1, float b2,
                                    float omb2, float eps, float rescale,
                                    float clip, float eta, int decoupled,
                                    void* stream, int* launched, int* bad) {
  using namespace mxt;
  *launched = 0;
  *bad = -1;
  if (count < 0) return cudaErrorInvalidValue;
  const AdamEntry* e = static_cast<const AdamEntry*>(table);
  for (int i = 0; i < count; ++i) {
    const uintptr_t any = reinterpret_cast<uintptr_t>(e[i].w) |
                          reinterpret_cast<uintptr_t>(e[i].g) |
                          reinterpret_cast<uintptr_t>(e[i].m) |
                          reinterpret_cast<uintptr_t>(e[i].v);
    // n < 2^34 (no card holds such a tensor's m and v): 2^22 chunks at most
    if (e[i].n < 0 || e[i].n >= (1LL << 34) ||
        (dtypes[i] != kF32 && dtypes[i] != kBF16) ||
        (e[i].n > 0 && any % 16 != 0)) {
      *bad = i;
      return cudaErrorInvalidValue;
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  AdamList L;
  L.b1 = b1; L.omb1 = omb1; L.b2 = b2; L.omb2 = omb2; L.eps = eps;
  L.rescale = rescale; L.clip = clip; L.eta = eta; L.decoupled = decoupled;
  L.count = 0;
  long long chunks = 0;
  auto flush = [&](int dt) {
    L.chunk_start[L.count] = (int)chunks;
    const cudaError_t err = dt == kF32 ? launch_adam<float>(L, s)
                                       : launch_adam<__nv_bfloat16>(L, s);
    if (err == cudaSuccess) ++*launched;
    L.count = 0;
    chunks = 0;
    return err;
  };
  for (const int dt : {int(kF32), int(kBF16)}) {
    for (int i = 0; i < count; ++i) {
      if (dtypes[i] != dt || e[i].n == 0) continue;
      const long long k = (e[i].n + ADAM_CHUNK - 1) / ADAM_CHUNK;
      // a launch's chunk ids (and a block's next one) stay ints
      if (L.count == ADAM_MAX_TENSORS || chunks + k > ADAM_MAX_CHUNKS) {
        const cudaError_t err = flush(dt);
        if (err != cudaSuccess) return err;
      }
      L.e[L.count] = e[i];
      L.chunk_start[L.count++] = (int)chunks;
      chunks += k;
    }
    if (L.count > 0) {
      const cudaError_t err = flush(dt);
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}
