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
//   with max_keep >= 0: keep &= (rank < max_keep), rank = cumsum(keep) - 1
// The wrapper does the rest in torch: the stable sort, the valid mask,
// top-k and the score rewrite.
//
// One thread block an image walks its rows in chunks of NMS_C. A row's
// keep is final once every earlier row is decided, so each chunk is
// decided whole before the next:
//  1. the chunk's boxes, their areas and class ids are staged in shared
//     memory (the next chunk's loads are in flight meanwhile);
//  2. cross test: every chunk row against the list of rows kept so far,
//     in parallel. The rows are taken in class order (a rank in shared
//     memory), 32 a warp, against a slice of the list, 4 entries a step:
//     a kept row of another class than all 32 is passed over by a warp
//     vote, before any IoU. A row stops at its first suppressor;
//  3. the chunk's upper-triangular suppression bitmask (NMS_C x NMS_C
//     bits), one warp ballot per 32 rows, skipping rows already out;
//  4. one warp scans the chunk's rows in order: each row's bitmask word
//     comes by a shuffle, off the dependent chain, and a row still in
//     clears the rows it marks; what is left in is kept, then cut to
//     max_keep. One barrier a chunk, not one a kept row.
// The kept list holds the kept rows' boxes, areas and ids: its first
// NMS_KEPT_SMEM entries in shared memory, the rest in a global scratch
// buffer from the wrapper (read back through L2). The walk stops at the
// image's last valid row or at its max_keep-th survivor, whichever comes
// first; every later row is written 0 and its box never read. So a
// decode that keeps the top 100 decides about 120 rows, not 2,535.
//
// IoU is `_corner_iou`'s formula in its order of operations, each step
// rounded to nearest (__fsub_rn, __fmul_rn, __fadd_rn), so that no FMA
// contraction flips an `iou > thresh` against the plain version; max and
// min propagate NaN as jnp.maximum/minimum and torch.clamp do (PTX
// max.NaN / min.NaN). The areas are computed once a row, the same way
// each time. The last step, `RN(inter / denom) > thresh`, is decided
// without the division, exactly (Thresh): IEEE division's slow path is a
// call that kept the IoU from being predicated. `clamp_area` 0 gives
// models/ssd.py's `_iou`, whose areas are not clamped at 0.
//
// What bounds it: latency on one SM an image, not bytes (each box read
// once up to the cut) nor the pairs the greedy loop must test, both far
// below. By phase (`python3 chip_smoke.py --nms-phases`, an instrumented
// copy on an H100): a YOLOv3-tiny decode's top-k path (one chunk) spends
// ~40% of its cycles in the chunk's bitmask and ~15% each in the valid-
// row pass and the scan; SSD's 400-survivor path (~24 chunks) and the
// paths without max_keep spend 45-80% in the cross test, whose warp steps
// (32 rows against 4 kept entries) grow with the kept list.
#include "common.cuh"

#include <float.h>
#include <limits.h>
#include <math.h>
#include <string.h>

namespace mxt {
namespace {

constexpr int NMS_THREADS = 1024;
constexpr int NMS_WARPS = NMS_THREADS / 32;
constexpr int NMS_C = 128;                       // rows a chunk
constexpr int NMS_W = NMS_C / 32;                // bitmask words a row
constexpr int NMS_KEPT_SMEM = 2048;              // kept-list entries in smem
constexpr int NMS_SLICES = NMS_WARPS / NMS_W;    // kept-list slices
constexpr int NMS_UNROLL = 4;                    // kept entries a step
static_assert(NMS_W == 4, "a bitmask row is one uint4");
static_assert(NMS_THREADS == 8 * NMS_C, "the class rank takes 8 lanes a row");
static_assert(NMS_KEPT_SMEM % (NMS_UNROLL * NMS_SLICES) == 0,
              "the scratch part of the list starts on a step");

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// (x2 - x1) * (y2 - y1) of a corner box, the sides clamped at 0 or not
__device__ __forceinline__ float box_area(float4 b, bool clamp_area) {
  float w = __fsub_rn(b.z, b.x), h = __fsub_rn(b.w, b.y);
  if (clamp_area) {
    w = max_nan(0.f, w);
    h = max_nan(0.f, h);
  }
  return __fmul_rn(w, h);
}

// The threshold test `RN(inter / denom) > thresh` without the division:
// with thresh's upper neighbour t+ (the next float) and mid = (thresh +
// t+) / 2, a quotient rounds above thresh exactly when it exceeds mid, or
// equals it and the tie rounds up (to t+, when thresh's last mantissa bit
// is odd). denom > 0, so that is inter > mid * denom, or equality and
// tie_up; in double, where mid (25 significant bits) times denom (24) is
// exact. A NaN on either side compares false, as the quotient's would.
// For thresh < 0 take mid = thresh: every quotient >= 0 is above it.
struct Thresh {
  double mid;
  bool tie_up;
};

// _corner_iou(bi, bj) > thresh, operation for operation, from the boxes
// and their areas
__device__ __forceinline__ bool iou_above(float4 bi, float area_i, float4 bj,
                                          float area_j, Thresh th) {
  const float ix =
      max_nan(0.f, __fsub_rn(min_nan(bi.z, bj.z), max_nan(bi.x, bj.x)));
  const float iy =
      max_nan(0.f, __fsub_rn(min_nan(bi.w, bj.w), max_nan(bi.y, bj.y)));
  const float inter = __fmul_rn(ix, iy);
  const float denom =
      max_nan(__fsub_rn(__fadd_rn(area_i, area_j), inter), 1e-12f);
  const double x = inter, p = __dmul_rn(th.mid, (double)denom);
  return x > p || (x == p && th.tie_up);
}

// Row i (box bi; ai = (area, class id)) suppresses row j. A row of
// another class compares as IoU 0 (`jnp.where(same, iou, 0.0)`), which
// still suppresses when thresh < 0 (other_class_hits = 0 > thresh).
__device__ __forceinline__ bool suppresses(float4 bi, float2 ai, float4 bj,
                                           float2 aj, Thresh th,
                                           bool other_class_hits) {
  if (ai.y != aj.y) return other_class_hits;
  return iou_above(bi, ai.x, bj, aj.x, th);
}

__global__ void __launch_bounds__(NMS_THREADS)
box_nms_keep_kernel(const float4* __restrict__ boxes,
                    const unsigned char* __restrict__ valid,
                    const float* __restrict__ ids,
                    unsigned char* __restrict__ keep_out, float4* spill_box,
                    float2* spill_ai, int cap, int ks, int N, Thresh th,
                    bool other_class_hits, int n_sup, int max_keep,
                    int clamp_area) {
  // the kept list: ks entries in dynamic shared memory, boxes then
  // (area, class id); entries k >= ks in the scratch (cap an image)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float4* kbox = reinterpret_cast<float4*>(smem_raw);
  float2* kai = reinterpret_cast<float2*>(kbox + ks);
  float4* gbox = spill_box + (long long)blockIdx.x * cap;
  float2* gai = spill_ai + (long long)blockIdx.x * cap;
  // two chunk buffers (one staged while the other is decided)
  __shared__ float4 s_box[2][NMS_C];
  __shared__ float2 s_ai[2][NMS_C];            // (area, class id)
  __shared__ unsigned char s_out[2][NMS_C];    // 1: invalid or suppressed
  __shared__ __align__(16) uint32_t s_mask[NMS_C][NMS_W];
  __shared__ uint32_t s_kept[NMS_W];
  __shared__ unsigned short s_order[NMS_C];    // rows in class order
  __shared__ int s_last, s_count;
  const long long base = (long long)blockIdx.x * N;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool clamp = clamp_area != 0;
  const int maxk = max_keep < 0 ? INT_MAX : max_keep;

  // the last valid row: rows after it are invalid and cannot suppress
  if (t == 0) s_last = -1;
  __syncthreads();
  int last = -1;
  for (int j = t; j < N; j += NMS_THREADS)
    if (valid[base + j]) last = j;
  last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0 && last >= 0) atomicMax(&s_last, last);
  __syncthreads();
  const int nrows = max_keep == 0 ? 0 : s_last + 1;

  // a chunk row in registers (threads t < C) until it is staged
  float4 pb = make_float4(0.f, 0.f, 0.f, 0.f);
  float pid = 0.f;
  bool pv = false;
  auto fetch = [&](int c0) {
    const int j = c0 + t;
    pv = t < NMS_C && j < nrows && valid[base + j] != 0;
    if (pv) {
      pb = boxes[base + j];
      pid = ids ? ids[base + j] : 0.f;
    }
  };
  auto stage = [&](int buf) {
    if (t < NMS_C) {
      s_box[buf][t] = pb;
      s_ai[buf][t] = make_float2(box_area(pb, clamp), pid);
      s_out[buf][t] = !pv;
    }
  };
  fetch(0);
  stage(0);
  __syncthreads();

  int nk = 0, count = 0, end = 0;
  for (int c0 = 0, buf = 0; c0 < nrows; c0 += NMS_C, buf ^= 1) {
    end = c0 + NMS_C;
    if (end < nrows) fetch(end);
    const float4* cb = s_box[buf];
    const float2* ca = s_ai[buf];
    unsigned char* co = s_out[buf];

    // 2. cross test, rows in class order: warp w takes 32 of them and the
    //    kept entries k = w / 4 + 8 m, 4 a step, so a kept row of another
    //    class than all 32 is passed over whole; a row stops at its first
    //    suppressor, and its 8 warps poll its flag
    if (nk > 0) {
      {   // rank by (out, class id bits, row): 8 lanes a row
        const int r = t >> 3, part = t & 7;
        const unsigned long long key =
            (unsigned long long)co[r] << 32 | __float_as_uint(ca[r].y);
        int rank = 0;
        for (int j = part; j < NMS_C; j += 8) {
          const unsigned long long kj =
              (unsigned long long)co[j] << 32 | __float_as_uint(ca[j].y);
          rank += kj < key || (kj == key && j < r);
        }
        rank += __shfl_xor_sync(0xffffffffu, rank, 1);
        rank += __shfl_xor_sync(0xffffffffu, rank, 2);
        rank += __shfl_xor_sync(0xffffffffu, rank, 4);
        if (part == 0) s_order[rank] = static_cast<unsigned short>(r);
      }
      __syncthreads();
      const int r = s_order[(warp % NMS_W) * 32 + lane];
      volatile unsigned char* vo = co;
      const float4 bj = cb[r];
      const float2 aj = ca[r];
      bool live = !vo[r];
      // entries [from, to) of one part of the list (shared or scratch)
      auto cross = [&](const float4* kb, const float2* ka, int from, int to) {
        for (int k0 = from + warp / NMS_W; k0 < to;
             k0 += NMS_UNROLL * NMS_SLICES) {
          if (!__any_sync(0xffffffffu, live)) return;
          float2 ak[NMS_UNROLL];
#pragma unroll
          for (int u = 0; u < NMS_UNROLL; ++u) {
            const int k = k0 + u * NMS_SLICES;
            ak[u] = k < to ? ka[k] : make_float2(0.f, 0.f);
          }
          bool hit = false;
#pragma unroll
          for (int u = 0; u < NMS_UNROLL; ++u) {
            const int k = k0 + u * NMS_SLICES;
            const bool same = live && k < to && ak[u].y == aj.y;
            hit |= live && k < to && !same && other_class_hits;
            if (__any_sync(0xffffffffu, same))     // else no IoU at all
              hit |= same && iou_above(kb[k], ak[u].x, bj, aj.x, th);
          }
          if (hit) vo[r] = 1;
          live = live && !hit && !vo[r];
        }
      };
      cross(kbox, kai, 0, nk < ks ? nk : ks);
      if (nk > ks) cross(gbox, gai, ks, nk);
    }
    __syncthreads();

    // 3. the bitmask: word w of row i has bit l when row i suppresses row
    //    32 w + l > i. Only rows still in are computed (those past
    //    n_suppressors get 0).
    for (int i = warp; i < NMS_C; i += NMS_WARPS) {
      if (co[i]) continue;
      const bool may = c0 + i < n_sup;
      const float4 bi = cb[i];
      const float2 ai = ca[i];
      for (int w = i >> 5; w < NMS_W; ++w) {
        const int j = w * 32 + lane;
        const bool hit = may && j > i && !co[j] &&
                         suppresses(bi, ai, cb[j], ca[j], th,
                                    other_class_hits);
        const uint32_t bits = __ballot_sync(0xffffffffu, hit);
        if (lane == 0) s_mask[i][w] = bits;
      }
    }
    __syncthreads();

    // 4. the scan, in row order, by warp 0: lane l holds row 32 w + l's
    //    bitmask row; for each row in order, its word w comes by a shuffle
    //    (independent of the chain) and, if the row is still in, clears
    //    the rows it marks. What is left in are the kept rows. The words
    //    past w gather the kept rows' marks by one OR-reduction a word.
    //    The max_keep cut comes after: rows past it are dropped whatever
    //    they suppressed.
    if (warp == 0) {
      uint32_t rem[NMS_W] = {0u, 0u, 0u, 0u};
      int left = maxk - count;
#pragma unroll
      for (int w = 0; w < NMS_W; ++w) {
        const uint4 m4 =
            *reinterpret_cast<const uint4*>(s_mask[w * 32 + lane]);
        const uint32_t m[NMS_W] = {m4.x, m4.y, m4.z, m4.w};
        uint32_t a = __ballot_sync(0xffffffffu, !co[w * 32 + lane]) & ~rem[w];
#pragma unroll
        for (int b = 0; b < 32; ++b) {
          const uint32_t mb = __shfl_sync(0xffffffffu, m[w], b);
          if (a & (1u << b)) a &= ~mb;
        }
#pragma unroll
        for (int w2 = w + 1; w2 < NMS_W; ++w2)
          rem[w2] |= __reduce_or_sync(0xffffffffu,
                                      (a >> lane) & 1u ? m[w2] : 0u);
        const int n = __popc(a);
        if (n > left) {                // keep the first `left` of them
          uint32_t past = a;
          for (int c = 0; c < left; ++c) past &= past - 1u;
          a &= ~past;
        }
        left -= n < left ? n : left;
        if (lane == 0) s_kept[w] = a;
      }
      if (lane == 0) s_count = maxk - left;
    }
    __syncthreads();

    // the new kept rows (those that may suppress, a prefix of the
    // chunk's) join the list in row order; the chunk's keep bytes; the
    // next chunk is staged in the other buffer
    const int lim = min(max(n_sup - c0, 0), NMS_C);
    int nnew = 0, below = 0;
#pragma unroll
    for (int w = 0; w < NMS_W; ++w) {
      const uint32_t kw = s_kept[w];
      const int lo = w * 32;
      const uint32_t in = lim >= lo + 32 ? ~0u
                          : lim <= lo ? 0u : (1u << (lim - lo)) - 1u;
      nnew += __popc(kw & in);
      if (t < NMS_C && (t >> 5) > w) below += __popc(kw);
      if (t < NMS_C && (t >> 5) == w)
        below += __popc(kw & ((1u << (t & 31)) - 1u));
    }
    count = s_count;
    if (t < lim && ((s_kept[t >> 5] >> (t & 31)) & 1u)) {
      const int k = nk + below;
      if (k < ks) {
        kbox[k] = cb[t];
        kai[k] = ca[t];
      } else {
        gbox[k] = cb[t];
        gai[k] = ca[t];
      }
    }
    if (t < NMS_C && c0 + t < N)
      keep_out[base + c0 + t] = (s_kept[t >> 5] >> (t & 31)) & 1u;
    nk += nnew;
    if (count >= maxk) break;
    stage(buf ^ 1);
    __syncthreads();
  }
  // rows after the last chunk decided: not kept
  for (int j = end + t; j < N; j += NMS_THREADS) keep_out[base + j] = 0;
}

bool smem_configured = false;

}  // namespace
}  // namespace mxt

// boxes (B, N, 4) float32 corner boxes sorted by score, valid (B, N) bytes
// 0/1 (a bool tensor), ids (B, N) float32 or null (no class test), keep
// (B, N) bytes 0/1 out; all contiguous on one device, boxes 16-byte
// aligned. Rows i < n_suppressors may suppress; max_keep >= 0 keeps only
// the first max_keep survivors (-1: all). scratch: room for cap = min(N,
// n_suppressors, max_keep) kept entries an image, (B, cap, 4) float32
// then (B, cap, 2) float32, 16-byte aligned (only entries past the
// shared-memory list are written). Returns the CUDA error of the launch.
extern "C" int mx_box_nms_keep(const void* boxes, const void* valid,
                               const void* ids, void* keep, void* scratch,
                               int B, int N, float thresh, int n_suppressors,
                               int max_keep, int clamp_area, void* stream) {
  using namespace mxt;
  if (B <= 0 || N <= 0 || n_suppressors < 0 || n_suppressors > N ||
      max_keep < -1)
    return cudaErrorInvalidValue;
  int cap = n_suppressors;
  if (max_keep >= 0 && max_keep < cap) cap = max_keep;
  const int ks = cap < NMS_KEPT_SMEM ? cap : NMS_KEPT_SMEM;
  cudaError_t e = allow_smem(box_nms_keep_kernel, NMS_KEPT_SMEM * 24,
                             smem_configured);
  if (e != cudaSuccess) return e;
  // the threshold test's constants (see Thresh)
  Thresh th{0.0, false};
  if (thresh != thresh || thresh == INFINITY) {
    th.mid = thresh;                     // nothing is above it
  } else if (thresh < 0.f) {
    th.mid = thresh;                     // every quotient >= 0 is above it
  } else {                               // 0 (either sign) or positive
    const float up = nextafterf(thresh, INFINITY);
    th.mid = up == INFINITY ? (double)FLT_MAX + ldexp(1.0, 103)
                            : ((double)thresh + (double)up) / 2;
    uint32_t bits;
    memcpy(&bits, &thresh, sizeof bits);
    th.tie_up = (bits & 1u) != 0;
  }
  float4* spill_box = static_cast<float4*>(scratch);
  float2* spill_ai = reinterpret_cast<float2*>(
      static_cast<float*>(scratch) + (long long)B * cap * 4);
  box_nms_keep_kernel<<<B, NMS_THREADS, ks * 24,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes),
      static_cast<const unsigned char*>(valid),
      static_cast<const float*>(ids), static_cast<unsigned char*>(keep),
      spill_box, spill_ai, cap, ks, N, th, 0.f > thresh, n_suppressors,
      max_keep, clamp_area);
  return cudaGetLastError();
}
