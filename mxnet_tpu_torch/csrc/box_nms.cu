// Greedy non-maximum suppression for Hopper (sm_90a), hand-written CUDA C++.
//
// Not a Pallas kernel. It replaces the `lax.fori_loop` over the N candidate
// rows of mxnet_tpu/ops/detection_ops.py:84 (`box_nms`) and of
// mxnet_tpu/models/ssd.py:125 (`non_max_suppression`): a loop the JAX
// package keeps on the device inside jit, which eager PyTorch can only run
// as N rounds of launches from the host. Launched by `box_nms_keep`
// (cuda_ops/box_nms.py) in every decode of the detection models
// (`decode_predictions`, `multibox_detection`, `non_max_suppression`) and
// in `proposal`.
//
// It computes only the keep mask of rows that are already sorted by score:
//   keep = valid
//   for i < min(N, n_suppressors):
//     if keep[i]: keep[j] = false for every j > i with iou(i, j) > thresh
//                 (and, with class ids, ids[i] == ids[j])
// The wrapper does the rest in torch: the stable sort, the valid mask,
// top-k and the score rewrite.
//
// One thread block per image. The keep mask is a bitmap in shared memory
// (N / 32 words). The boxes (and class ids) are copied into shared memory
// when they fit (2,535 rows are 40.6 KB of boxes: YOLOv3-tiny at 416^2) and
// read from global memory, where they stay in L2, otherwise (30,120 rows at
// SSD300's shape). Every thread scans the bitmap for the next kept row i,
// so suppressed rows cost a shared-memory read, no barrier. For a kept
// row each warp owns whole 32-row words of the bitmap: lane l tests row
// 32 w + l (j > i, still kept, same class), the warp's ballot clears the
// suppressed bits with one store, and a barrier ends the row. Rows past
// the last valid one are never tested.
//
// IoU is `_corner_iou`'s formula in its order of operations, each step
// rounded to nearest (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn), so that
// no FMA contraction flips an `iou > thresh` against the plain version;
// max and min propagate NaN as jnp.maximum/minimum and torch.clamp do.
// `clamp_area` 0 gives models/ssd.py's `_iou`, whose areas are not clamped
// at 0.
//
// What bounds it: the sequential chain of kept rows, one barrier each, and
// for each kept row one pass over the later rows' boxes (shared memory or
// L2). The byte bound (each box read once) is far below that.
#include "common.cuh"

namespace mxt {
namespace {

constexpr int NMS_THREADS = 512;
constexpr int NMS_WARPS = NMS_THREADS / 32;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

// _corner_iou of corner boxes (x1, y1, x2, y2), operation for operation
__device__ __forceinline__ float corner_iou(float4 a, float4 b,
                                            bool clamp_area) {
  const float ix =
      nan_max(0.f, __fsub_rn(nan_min(a.z, b.z), nan_max(a.x, b.x)));
  const float iy =
      nan_max(0.f, __fsub_rn(nan_min(a.w, b.w), nan_max(a.y, b.y)));
  const float inter = __fmul_rn(ix, iy);
  float wa = __fsub_rn(a.z, a.x), ha = __fsub_rn(a.w, a.y);
  float wb = __fsub_rn(b.z, b.x), hb = __fsub_rn(b.w, b.y);
  if (clamp_area) {
    wa = nan_max(0.f, wa);
    ha = nan_max(0.f, ha);
    wb = nan_max(0.f, wb);
    hb = nan_max(0.f, hb);
  }
  const float area_a = __fmul_rn(wa, ha);
  const float area_b = __fmul_rn(wb, hb);
  const float denom =
      nan_max(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-12f);
  return __fdiv_rn(inter, denom);
}

// the first set bit at or after `start` and below `limit`, else `limit`
__device__ __forceinline__ int next_kept(const uint32_t* keep, int start,
                                         int limit) {
  if (start >= limit) return limit;
  int w = start >> 5;
  uint32_t bits = keep[w] & (~0u << (start & 31));
  while (bits == 0) {
    if (++w * 32 >= limit) return limit;
    bits = keep[w];
  }
  const int r = w * 32 + __ffs(bits) - 1;
  return r < limit ? r : limit;
}

// the bitmap's bytes, rounded up to 16 so that the boxes after it align
__host__ __device__ __forceinline__ int bitmap_bytes(int N) {
  return ((N + 31) / 32 * 4 + 15) / 16 * 16;
}

template <bool SMEM>
__global__ void __launch_bounds__(NMS_THREADS)
box_nms_keep_kernel(const float4* __restrict__ boxes,
                    const unsigned char* __restrict__ valid,
                    const float* __restrict__ ids,
                    unsigned char* __restrict__ keep_out, int N, float thresh,
                    int n_sup, int clamp_area) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  uint32_t* keep = reinterpret_cast<uint32_t*>(smem);
  float4* sbox = reinterpret_cast<float4*>(smem + bitmap_bytes(N));
  float* sid = reinterpret_cast<float*>(sbox + N);
  const long long base = (long long)blockIdx.x * N;
  const float4* gbox = boxes + base;
  const float* gid = ids ? ids + base : nullptr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int words = (N + 31) / 32;

  if (threadIdx.x == 0) last = -1;
  __syncthreads();
  // keep = valid, one ballot a word; the last valid row
  for (int w = warp; w < words; w += NMS_WARPS) {
    const int j = w * 32 + lane;
    const bool v = j < N && valid[base + j] != 0;
    const uint32_t bits = __ballot_sync(0xffffffffu, v);
    if (lane == 0) {
      keep[w] = bits;
      if (bits) atomicMax(&last, w * 32 + 31 - __clz(bits));
    }
  }
  if (SMEM) {
    for (int j = threadIdx.x; j < N; j += NMS_THREADS) {
      sbox[j] = gbox[j];
      if (ids) sid[j] = gid[j];
    }
  }
  __syncthreads();
  const float4* box = SMEM ? sbox : gbox;
  const float* cid = SMEM ? sid : gid;
  const int limit = min(last + 1, n_sup);     // rows that may suppress
  const int wlast = last >> 5;

  for (int i = next_kept(keep, 0, limit); i < limit;
       i = next_kept(keep, i + 1, limit)) {
    const float4 bi = box[i];
    const float ci = ids ? cid[i] : 0.f;
    for (int w = ((i + 1) >> 5) + warp; w <= wlast; w += NMS_WARPS) {
      const uint32_t bits = keep[w];
      if (bits == 0) continue;                 // the whole warp skips
      const int j = w * 32 + lane;
      bool sup = false;
      if (j > i && ((bits >> lane) & 1u)) {
        // a row of another class compares as IoU 0 (`jnp.where(same, iou,
        // 0.0)`), which still suppresses when thresh < 0
        const float v = (!ids || cid[j] == ci)
                            ? corner_iou(bi, box[j], clamp_area != 0)
                            : 0.f;
        sup = v > thresh;
      }
      const uint32_t m = __ballot_sync(0xffffffffu, sup);
      if (lane == 0 && m) keep[w] = bits & ~m;
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < N; j += NMS_THREADS)
    keep_out[base + j] = (keep[j >> 5] >> (j & 31)) & 1u;
}

// dynamic shared memory a block may take: the card's 227 KB less a margin
// for the kernel's static `last`
constexpr int SMEM_LIMIT = 227 * 1024 - 1024;
bool smem_configured[2] = {false, false};

int smem_bytes(int N, bool stage, bool with_ids) {
  return bitmap_bytes(N) + (stage ? N * (with_ids ? 20 : 16) : 0);
}

}  // namespace
}  // namespace mxt

// 1 when one image's boxes (and class ids) fit in shared memory beside the
// bitmap, so that mx_box_nms_keep may stage them there.
extern "C" int mx_box_nms_stage_fits(int N, int with_ids) {
  return mxt::smem_bytes(N, true, with_ids != 0) <= mxt::SMEM_LIMIT;
}

// boxes (B, N, 4) float32 corner boxes sorted by score, valid (B, N) uint8,
// ids (B, N) float32 or null (no class test), keep (B, N) uint8 out; all
// contiguous on one device, boxes 16-byte aligned. Rows i < n_suppressors
// may suppress. stage_smem: copy boxes and ids into shared memory (the
// caller asked mx_box_nms_stage_fits). Returns the CUDA error of the
// launch.
extern "C" int mx_box_nms_keep(const void* boxes, const void* valid,
                               const void* ids, void* keep, int B, int N,
                               float thresh, int n_suppressors,
                               int clamp_area, int stage_smem, void* stream) {
  using namespace mxt;
  const bool with_ids = ids != nullptr;
  const int bytes = smem_bytes(N, stage_smem != 0, with_ids);
  if (B <= 0 || N <= 0 || bytes > SMEM_LIMIT) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* bx = static_cast<const float4*>(boxes);
  const unsigned char* vd = static_cast<const unsigned char*>(valid);
  const float* id = static_cast<const float*>(ids);
  unsigned char* kp = static_cast<unsigned char*>(keep);
  auto kernel = stage_smem ? box_nms_keep_kernel<true>
                           : box_nms_keep_kernel<false>;
  if (bytes > 48 * 1024) {
    cudaError_t e = allow_smem(kernel, SMEM_LIMIT,
                               smem_configured[stage_smem ? 1 : 0]);
    if (e != cudaSuccess) return e;
  }
  kernel<<<B, NMS_THREADS, bytes, st>>>(bx, vd, id, kp, N, thresh,
                                        n_suppressors, clamp_area);
  return cudaGetLastError();
}
