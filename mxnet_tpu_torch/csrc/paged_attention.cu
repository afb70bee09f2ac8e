// Paged decode attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `_kernel` of
// mxnet_tpu/pallas_ops/paged_attention.py (launched by
// `_paged_attention_pallas`): single-query attention of row b over the
// positions <= t[b] of its KV cache, which lives as a list of fixed-size
// pages in a pooled (P, H, page_size, D) array, page ids in tables[b, :].
// Online softmax across pages in float32, scores masked to -1e30 past t[b],
// output in q's dtype.
//
// What bounds it: every K/V element is read once and used for 2 operations,
// far below the card's ~295 operations per byte, so it is bound by the
// bytes it reads. The design reads each page's (page_size, D) K and V
// straight from the pool with 16-byte loads; the gathered (B, H, L, D)
// operand of the plain version is never written to device memory, which is
// the point of the TPU kernel. The TPU grid's scalar prefetch of page ids
// has no counterpart: each block reads its own ids from `tables`. A block
// stops after the page holding t[b] (the positions past it would be masked
// to zero weight), so it reads only what the data needs.
//
// One block of 8 warps per (h, b). The TPU kernel walks the pages in
// order on one core; here the warps take pages round-robin, so eight
// pages' loads are in flight at once, each warp keeping its own running
// max, denominator and output, with no block-wide barrier inside the loop.
// A warp stages 16 positions of K and V at a time in its own shared memory
// (rows padded to D + 1 floats so lane-per-row reads hit distinct banks);
// lanes 0-15 and 16-31 each take half of a row's dot product. The eight
// partial softmax states are merged once at the end. Split-K across blocks
// over the pages (flash-decoding) is queued in ROADMAP.md.
#include "common.cuh"

namespace mxt {
namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int CH = 16;          // positions a warp stages at a time
constexpr int MAXI = 4;         // output dims per lane: lane + 32 i, D <= 128
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

__host__ __device__ constexpr int smem_floats(int D) {
  // q, per-warp K and V chunks, per-warp (m, l) and outputs for the merge
  return D + WARPS * 2 * CH * (D + 1) + 2 * WARPS + WARPS * D;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp, const int* __restrict__ tables,
                       const int* __restrict__ t, T* __restrict__ out, int H,
                       int ps, int D, int n_pg, float sm_scale) {
  extern __shared__ __align__(16) float sm[];
  const int SD = D + 1;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* qs = sm;
  float* Ks = sm + D + warp * 2 * CH * SD;
  float* Vs = Ks + CH * SD;
  float* mrg = sm + D + WARPS * 2 * CH * SD;   // m[WARPS], l[WARPS], o[WARPS][D]

  const T* qb = q + ((size_t)b * H + h) * D;
  for (int i = tid; i < D; i += THREADS) qs[i] = to_f<T>(qb[i]);
  __syncthreads();

  const int tb = t[b];
  // t < 0 masks every position: the reference then averages over all of
  // them, so walk the whole table
  const int npages = tb < 0 ? n_pg : min(n_pg, tb / ps + 1);
  const int vpr = D / Vec<T>::n;               // 16-byte vectors per row
  const int row = lane & (CH - 1), half = lane >> 4;
  const int d0 = half * (D / 2), d1 = d0 + D / 2;
  float acc[MAXI];
#pragma unroll
  for (int i = 0; i < MAXI; ++i) acc[i] = 0.f;
  float m = kNeg, l = 0.f;

  for (int pg = warp; pg < npages; pg += WARPS) {
    const size_t base =
        ((size_t)tables[(size_t)b * n_pg + pg] * H + h) * ps * D;
    for (int j0 = 0; j0 < ps; j0 += CH) {
      const int nj = min(CH, ps - j0);
      __syncwarp();                          // last chunk's readers are done
      for (int i = lane; i < nj * vpr; i += 32) {
        const int r = i / vpr, c = (i % vpr) * Vec<T>::n;
        const size_t g = base + (size_t)(j0 + r) * D + c;
        load_vec_f32<T>(Ks + r * SD + c, kp + g);
        load_vec_f32<T>(Vs + r * SD + c, vp + g);
      }
      __syncwarp();
      float dot = 0.f;
      if (row < nj) {
        const float* kr = Ks + row * SD;
        for (int d = d0; d < d1; ++d) dot = fmaf(qs[d], kr[d], dot);
      }
      dot += __shfl_xor_sync(FULL, dot, 16);
      float s = -INFINITY;                   // not a position: zero weight
      if (half == 0 && row < nj)
        s = (pg * ps + j0 + row <= tb) ? dot * sm_scale : kNeg;
      const float m_new = fmaxf(m, warp_max(s));
      const float alpha = expf(m - m_new);
      const float p = expf(s - m_new);
      l = l * alpha + warp_sum(p);
      m = m_new;
#pragma unroll
      for (int i = 0; i < MAXI; ++i) acc[i] *= alpha;
      for (int jj = 0; jj < nj; ++jj) {
        const float pj = __shfl_sync(FULL, p, jj);
        const float* vr = Vs + jj * SD;
#pragma unroll
        for (int i = 0; i < MAXI; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc[i] = fmaf(pj, vr[d], acc[i]);
        }
      }
    }
  }

  // merge the warps' partial softmax states (a warp without pages holds
  // m = -1e30, l = 0 and contributes nothing unless every score is masked)
  if (lane == 0) {
    mrg[warp] = m;
    mrg[WARPS + warp] = l;
  }
#pragma unroll
  for (int i = 0; i < MAXI; ++i) {
    const int d = lane + 32 * i;
    if (d < D) mrg[2 * WARPS + warp * D + d] = acc[i];
  }
  __syncthreads();
  if (tid < D) {
    float M = kNeg;
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, mrg[w]);
    float L = 0.f, o = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(mrg[w] - M);
      L += mrg[WARPS + w] * f;
      o += mrg[2 * WARPS + w * D + tid] * f;
    }
    out[((size_t)b * H + h) * D + tid] = from_f<T>(o / L);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* tables, const void* t, void* out, int B, int H,
                   int ps, int D, int n_pg, float sm_scale,
                   cudaStream_t stream) {
  const int bytes = smem_floats(D) * 4;
  static bool configured = false;            // above 48 KB needs an opt-in
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_floats(128) * 4);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  dim3 grid(H, B);
  paged_attention_kernel<T><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int*>(tables),
      static_cast<const int*>(t), static_cast<T*>(out), H, ps, D, n_pg,
      sm_scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mxt

// q (B,H,D) and out (B,H,D) in the pages' dtype (0 = float32, 1 = bfloat16);
// k/v pages (P,H,ps,D) contiguous; tables (B,n_pg) int32; t (B,) int32.
// D % 8 == 0, D <= 128. Returns the CUDA error of the launch (0 on success).
extern "C" int mx_paged_attention(const void* q, const void* kp, const void* vp,
                                  const void* tables, const void* t, void* out,
                                  int B, int H, int ps, int D, int n_pg,
                                  float sm_scale, int dtype, void* stream) {
  using namespace mxt;
  if (D <= 0 || D > 128 || D % 8 != 0 || ps <= 0 || n_pg <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float>(q, kp, vp, tables, t, out, B, H, ps, D, n_pg,
                         sm_scale, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(q, kp, vp, tables, t, out, B, H, ps, D, n_pg,
                                 sm_scale, s);
  return cudaErrorInvalidValue;
}
