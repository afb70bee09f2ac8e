// Paged decode attention for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `_kernel` of
// mxnet_tpu/pallas_ops/paged_attention.py (launched by
// `_paged_attention_pallas`): single-query attention of row b over the
// positions <= t[b] of its KV cache, which lives as a list of fixed-size
// pages in a pooled (P, H, page_size, D) array, page ids in tables[b, :].
// Online softmax in float32, scores replaced by -1e30 past t[b] (t < 0
// masks every position, so the row averages over its whole table), output
// in q's dtype.
//
// What bounds it: every K/V element is read once and used for 2
// operations, far below the card's ~295 operations per byte, so it is
// bound by the bytes it reads: at the serving shapes a few megabytes, a
// few microseconds at 3.35 TB/s. What stands in the way is latency: a row
// holds only tens of pages, so the whole card has to have its pages in
// flight at once. The gathered (B, H, L, D) operand of the plain version
// is never written to device memory, which is the point of the TPU
// kernel; the TPU grid's scalar prefetch of page ids has no counterpart:
// each block stages its row of `tables` itself.
//
// Flash-decoding in one launch. The work of row b, head h is its units:
// chunks of up to 16 positions of one page, up to and including the chunk
// that holds t[b] (later positions would get zero weight). A thread-block
// cluster of `split` blocks (grid (split, H, B)) shares them: rank r takes
// the r-th of `split` equal runs of units, counted on the device from
// t[b], so short rows are not left to one block. Inside a block each of
// 4 warps takes every 4th unit of the run and streams it through its own
// ring of 3 stages: lane 0 copies the unit's (rows, D) slabs of K and V,
// each contiguous in the pool, with 1-D bulk copies (cp.async.bulk)
// completing on the stage's mbarrier, so up to 12 units a block are in
// flight while the warps compute. A warp takes its units two at a time,
// a half-warp each: a lane scores one row (its 16-byte chunks read in a
// rotated order, so a load phase touches 8 bank groups), then sums its
// half's 16 rows into the output pairs d = 2 (lane % 16) + 32 c, and the
// halves add up at the end (consecutive stages sit 64 bytes apart modulo
// 128, so the halves of most pairs read different banks). The
// exponentials are base 2 on scores scaled by log2 e. Every warp keeps
// its own running max, denominator and output; the warps of every rank
// write these partial states into rank 0's shared memory (distributed
// shared memory), and after one cluster barrier rank 0 merges them and
// writes the output: no second launch and no scratch in device memory.
// The split is chosen per call from B*H and the table width: the
// smallest power of two (at most 8, the portable cluster size) that
// gives the card two blocks an SM, as long as each warp would still get
// two units of a full table: 4 at phase 1's shape of chip_smoke.py
// (8 x 12 rows, 64-page tables), 1 at the steady-decode shape (8 slots,
// 7-page tables). A block of bf16 D = 64 takes 54 KB of shared memory,
// so four share an SM and the 384 blocks of the split-4 launch start
// together.
#include <cooperative_groups.h>

#include "hopper.cuh"

namespace mxt {
namespace {

constexpr int PA_WARPS = 4;        // warps of a block, at most
constexpr int PA_SMEM = 113 << 10; // two blocks an SM: fewer warps past it
constexpr int PA_CH = 16;          // positions of a unit
constexpr int PA_STAGES = 3;       // the ring of a warp
constexpr int PA_MAX_SPLIT = 8;    // the portable cluster size
constexpr int PA_TBL = 1024;       // table entries staged in shared memory
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

// elements d and d + 1 of a row, as float
template <typename T> __device__ __forceinline__ float2 load2(const T* p);
template <> __device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <>
__device__ __forceinline__ float2 load2<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// q . (one 16-byte chunk of a K row): the chunk's 4 (float32) or 8
// (bfloat16) elements against q's, which sit in shared memory as 16-byte
// quarters, quarter e of chunk c at qs + 4 (e * nch + c)
__device__ __forceinline__ float dot_chunk(const float* krow, const float* qs,
                                           int c, int nch, float acc) {
  const float4 k = *reinterpret_cast<const float4*>(krow + 4 * c);
  const float4 q = *reinterpret_cast<const float4*>(qs + 4 * c);
  acc = fmaf(q.x, k.x, acc);
  acc = fmaf(q.y, k.y, acc);
  acc = fmaf(q.z, k.z, acc);
  return fmaf(q.w, k.w, acc);
}
__device__ __forceinline__ float dot_chunk(const __nv_bfloat16* krow,
                                           const float* qs, int c, int nch,
                                           float acc) {
  const uint4 u = *reinterpret_cast<const uint4*>(krow + 8 * c);
  const float4 q0 = *reinterpret_cast<const float4*>(qs + 4 * c);
  const float4 q1 = *reinterpret_cast<const float4*>(qs + 4 * (nch + c));
  using B2 = __nv_bfloat162;
  const float2 a = __bfloat1622float2(*reinterpret_cast<const B2*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const B2*>(&u.y));
  const float2 e = __bfloat1622float2(*reinterpret_cast<const B2*>(&u.z));
  const float2 f = __bfloat1622float2(*reinterpret_cast<const B2*>(&u.w));
  acc = fmaf(q0.x, a.x, acc);
  acc = fmaf(q0.y, a.y, acc);
  acc = fmaf(q0.z, b.x, acc);
  acc = fmaf(q0.w, b.y, acc);
  acc = fmaf(q1.x, e.x, acc);
  acc = fmaf(q1.y, e.y, acc);
  acc = fmaf(q1.z, f.x, acc);
  return fmaf(q1.w, f.y, acc);
}

// shared memory of a block (bytes): the warps' rings of K and V slabs
// (stage s of a ring at s * stage, stage = 2 slabs + 64 bytes, so
// consecutive stages sit 64 bytes apart modulo the 128 bytes of the banks),
// their mbarriers, q as float, the partial states rank 0 merges (split *
// warps of m, l and D outputs), the row's page ids
struct PagedPlan {
  int slab, stage, ring, bar_off, q_off, mrg_off, tbl_off, bytes;
  __host__ __device__ PagedPlan(int D, int es, int warps, int split,
                                int tbl) {
    slab = PA_CH * D * es;                          // a multiple of 16
    stage = 2 * slab + 64;
    ring = PA_STAGES * stage;
    bar_off = warps * ring;
    q_off = (bar_off + warps * PA_STAGES * 8 + 15) & ~15;  // float4 reads
    mrg_off = q_off + D * 4;
    tbl_off = mrg_off + split * warps * (D + 2) * 4;
    bytes = tbl_off + tbl * 4;
  }
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(32 * PA_WARPS)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                       const T* __restrict__ vp, const int* __restrict__ tables,
                       const int* __restrict__ t, T* __restrict__ out, int H,
                       int ps, int D, int n_pg, int tbl, float scale2) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int W = blockDim.x >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const PagedPlan plan(D, sizeof(T), W, split, tbl);
  extern __shared__ __align__(16) uint8_t smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + plan.bar_off) +
                   warp * PA_STAGES;
  float* qs = reinterpret_cast<float*>(smem + plan.q_off);
  float* mrg = reinterpret_cast<float*>(smem + plan.mrg_off);
  int* ids_s = reinterpret_cast<int*>(smem + plan.tbl_off);
  uint8_t* ring = smem + warp * plan.ring;
  cluster_arrive_relaxed();                  // this block has started

  // t, the row's page ids and q load together: one memory latency. q goes
  // to shared memory as float in quarters of chunks (dot_chunk)
  const int tb = t[b];
  const int* row_ids = tables + (size_t)b * n_pg;
  for (int i = tid; i < tbl; i += blockDim.x) ids_s[i] = row_ids[i];
  const int* ids = tbl ? ids_s : row_ids;
  const int V = 16 / (int)sizeof(T), nch = D / V;   // a row's 16-byte chunks
  for (int d = tid; d < D; d += blockDim.x)
    qs[4 * ((d % V) / 4 * nch + d / V) + d % 4] =
        to_f<T>(q[((size_t)b * H + h) * D + d]);
  if (tid == 0) {
    for (int i = 0; i < W * PA_STAGES; ++i)
      mbar_init(reinterpret_cast<uint64_t*>(smem + plan.bar_off) + i, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // this rank's run of units, and this warp's every W-th of it
  const int cpp = (ps + PA_CH - 1) / PA_CH;  // units of a page
  int U = n_pg * cpp;                        // t < 0: the whole table
  if (tb >= 0) {
    const int last = min(tb, n_pg * ps - 1);
    U = (last / ps) * cpp + (last % ps) / PA_CH + 1;
  }
  const int sh = __ffs(split) - 1;           // split is a power of two
  const int lo = (rank * U) >> sh, hi = ((rank + 1) * U) >> sh;
  const int n = hi - lo > warp ? (hi - lo - warp + W - 1) / W : 0;
  // unit u is chunk u % cpp of page u / cpp: no division where cpp is 1
  auto page_of = [&](int u) { return cpp == 1 ? u : u / cpp; };

  auto issue = [&](int i) {                  // lane 0: unit i into its stage
    const int u = lo + warp + W * i, s = i % PA_STAGES;
    const int pg = page_of(u), r0 = (u - pg * cpp) * PA_CH;
    const uint32_t bytes = min(PA_CH, ps - r0) * D * (int)sizeof(T);
    const size_t src = (((size_t)ids[pg] * H + h) * ps + r0) * D;
    uint8_t* ks = ring + s * plan.stage;
    mbar_expect_tx(&bars[s], 2 * bytes);
    bulk_load(ks, kp + src, bytes, &bars[s]);
    bulk_load(ks + plan.slab, vp + src, bytes, &bars[s]);
  };
  if (lane == 0)
    for (int i = 0; i < min(n, PA_STAGES); ++i) issue(i);

  // units i and i + 1 at a time; lanes 16 hf .. 16 hf + 15 work on unit
  // i + hf. Scores: lane scores row lane % 16 (its chunks in a rotated
  // order, so the 8 lanes of a 16-byte load phase hit 8 bank groups). P.V:
  // the lane sums its half's 16 rows into the output pairs
  // d = 2 (lane % 16) + 32 c; the halves add up at the end. m is in the
  // log2 domain
  const int hf = lane >> 4, row = lane & 15, dl = 2 * row;
  const int ch0 = lane % nch;                // this lane's first chunk
  float acc[DMAX / 16];                      // pairs c = 0 .. DMAX / 32 - 1
#pragma unroll
  for (int k = 0; k < DMAX / 16; ++k) acc[k] = 0.f;
  float m = kNeg2, l = 0.f;                  // l: this lane's rows only
  for (int i = 0; i < n; i += 2) {
    const int iu = i + hf;                   // this lane's unit
    const int u = lo + warp + W * iu;
    const int pg = page_of(u), r0 = (u - pg * cpp) * PA_CH;
    const bool live = iu < n && row < ps - r0;
    const T* ks = reinterpret_cast<const T*>(ring + (iu % PA_STAGES) *
                                                        plan.stage);
    const T* vs = reinterpret_cast<const T*>(ring + (iu % PA_STAGES) *
                                                        plan.stage +
                                                    plan.slab);
    mbar_wait(&bars[i % PA_STAGES], (i / PA_STAGES) & 1);
    if (i + 1 < n) mbar_wait(&bars[(i + 1) % PA_STAGES],
                             ((i + 1) / PA_STAGES) & 1);
    float x = -INFINITY;                     // not a position: zero weight
    if (live) {
      const T* krow = ks + row * D;
      constexpr int NCH = DMAX * (int)sizeof(T) / 16;
      float dk[2] = {0.f, 0.f};              // two chains: even, odd chunks
      if (nch == NCH) {                      // D == DMAX: unrolled, no branch
#pragma unroll
        for (int k = 0; k < NCH; ++k) {
          const int c = ch0 + k;
          dk[k & 1] = dot_chunk(krow, qs, c < NCH ? c : c - NCH, NCH,
                                dk[k & 1]);
        }
      } else {
        for (int k = 0; k < nch; ++k) {
          const int c = ch0 + k;
          dk[k & 1] = dot_chunk(krow, qs, c < nch ? c : c - nch, nch,
                                dk[k & 1]);
        }
      }
      x = pg * ps + r0 + row <= tb ? (dk[0] + dk[1]) * scale2 : kNeg2;
    }
    const unsigned mine = (__ballot_sync(FULL, live) >> (16 * hf)) & 0xffffu;
    const float m_new = fmaxf(m, warp_max(x));
    const float alpha = ex2(m - m_new);
    const float p = ex2(x - m_new);
    l = l * alpha + p;
    m = m_new;
#pragma unroll
    for (int k = 0; k < DMAX / 16; ++k) acc[k] *= alpha;
    float pr[PA_CH];                         // the half's 16 weights
#pragma unroll
    for (int j = 0; j < PA_CH; ++j)
      pr[j] = __shfl_sync(FULL, p, (lane & 16) | j);
#pragma unroll
    for (int c = 0; c < DMAX / 32; ++c) {
      const int d = dl + 32 * c;
      if (d >= D) continue;
      if (mine == 0xffffu) {                 // every row: no branch inside
#pragma unroll
        for (int j = 0; j < PA_CH; ++j) {
          const float2 vv = load2<T>(vs + j * D + d);
          acc[2 * c] = fmaf(pr[j], vv.x, acc[2 * c]);
          acc[2 * c + 1] = fmaf(pr[j], vv.y, acc[2 * c + 1]);
        }
      } else {                               // rows past the page or the run
#pragma unroll
        for (int j = 0; j < PA_CH; ++j) {
          if ((mine >> j) & 1) {
            const float2 vv = load2<T>(vs + j * D + d);
            acc[2 * c] = fmaf(pr[j], vv.x, acc[2 * c]);
            acc[2 * c + 1] = fmaf(pr[j], vv.y, acc[2 * c + 1]);
          }
        }
      }
    }
    __syncwarp();                            // every lane is done with both
    if (lane == 0) {
      if (i + PA_STAGES < n) issue(i + PA_STAGES);
      if (i + 1 + PA_STAGES < n) issue(i + 1 + PA_STAGES);
    }
  }
  l = warp_sum(l);
#pragma unroll
  for (int k = 0; k < DMAX / 16; ++k)
    acc[k] += __shfl_xor_sync(FULL, acc[k], 16);

  // every warp's (m, l, o) into slot rank * W + warp of rank 0 (a warp
  // without units holds m = kNeg2, l = 0, o = 0 and adds nothing unless
  // every score is masked, when every slot's m is kNeg2 alike)
  cluster_wait();                            // every block has started
  float* dst = cluster.map_shared_rank(mrg, 0) + (rank * W + warp) * (D + 2);
  if (lane == 0) {
    dst[0] = m;
    dst[1] = l;
  }
  if (lane < 16) {
#pragma unroll
    for (int c = 0; c < DMAX / 32; ++c) {
      const int d = dl + 32 * c;
      if (d < D) {
        dst[2 + d] = acc[2 * c];
        dst[3 + d] = acc[2 * c + 1];
      }
    }
  }
  cluster.sync();                            // every partial has arrived
  if (rank != 0) return;
  // every thread weighs the slots by 2^(m_k - M) for its outputs
  const int slots = split * W;
  const float* st = mrg;
  float M = kNeg2;
#pragma unroll 4
  for (int k = 0; k < slots; ++k) M = fmaxf(M, st[k * (D + 2)]);
  for (int d = tid; d < D; d += blockDim.x) {
    float L = 0.f, o = 0.f;
#pragma unroll 4
    for (int k = 0; k < slots; ++k) {
      const float f = ex2(st[k * (D + 2)] - M);
      L = fmaf(st[k * (D + 2) + 1], f, L);
      o = fmaf(st[k * (D + 2) + 2 + d], f, o);
    }
    out[((size_t)b * H + h) * D + d] = from_f<T>(o / L);
  }
}

// the smallest power-of-two split (at most the cluster size) that gives
// every SM two blocks, while each of a cluster's warps would still get two
// units of a full table
int paged_split(int BH, int units, int warps) {
  const int sms = sm_count();
  int split = 1;
  while (split < PA_MAX_SPLIT && BH * split < 2 * sms &&
         units >= 2 * warps * 2 * split)
    split *= 2;
  return split;
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* kp, const void* vp,
                   const void* tables, const void* t, void* out, int B, int H,
                   int ps, int D, int n_pg, float sm_scale,
                   cudaStream_t stream) {
  const int tbl = n_pg <= PA_TBL ? n_pg : 0;
  int warps = PA_WARPS;         // 4 warps, fewer where their rings would
  while (warps > 1 &&           // keep a second block off the SM
         PagedPlan(D, sizeof(T), warps, PA_MAX_SPLIT, tbl).bytes > PA_SMEM)
    warps /= 2;
  const int split =
      paged_split(B * H, n_pg * ((ps + PA_CH - 1) / PA_CH), warps);
  const int bytes = PagedPlan(D, sizeof(T), warps, split, tbl).bytes;
  static int granted = 48 << 10;             // above 48 KB needs an opt-in
  if (bytes > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T, DMAX>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) {
      cudaGetLastError();       // not left for the next launch to report
      return e;
    }
    granted = bytes;
  }
  const float scale2 = sm_scale * kLog2e;
  cudaError_t e;
  if (split == 1) {                          // a cluster of one: no attribute
    paged_attention_kernel<T, DMAX>
        <<<dim3(1, H, B), 32 * warps, bytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kp),
        static_cast<const T*>(vp), static_cast<const int*>(tables),
        static_cast<const int*>(t), static_cast<T*>(out), H, ps, D, n_pg, tbl,
        scale2);
    e = cudaSuccess;
  } else {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(split, H, B);
    cfg.blockDim = dim3(32 * warps, 1, 1);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = split;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(
        &cfg, paged_attention_kernel<T, DMAX>, static_cast<const T*>(q),
        static_cast<const T*>(kp), static_cast<const T*>(vp),
        static_cast<const int*>(tables), static_cast<const int*>(t),
        static_cast<T*>(out), H, ps, D, n_pg, tbl, scale2);
  }
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace
}  // namespace mxt

// q (B,H,D) and out (B,H,D) in the pages' dtype (0 = float32, 1 = bfloat16);
// k/v pages (P,H,ps,D) contiguous, 16-byte aligned; tables (B,n_pg) int32;
// t (B,) int32. D % 8 == 0, D <= 128. Returns the CUDA error of the launch
// (0 on success).
extern "C" int mx_paged_attention(const void* q, const void* kp, const void* vp,
                                  const void* tables, const void* t, void* out,
                                  int B, int H, int ps, int D, int n_pg,
                                  float sm_scale, int dtype, void* stream) {
  using namespace mxt;
  if (D <= 0 || D > 128 || D % 8 != 0 || ps <= 0 || n_pg <= 0 || B <= 0 ||
      H <= 0 || B > 65535 || H > 65535 ||
      reinterpret_cast<uintptr_t>(kp) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(vp) % 16 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return D <= 64 ? launch<float, 64>(q, kp, vp, tables, t, out, B, H, ps, D,
                                       n_pg, sm_scale, s)
                   : launch<float, 128>(q, kp, vp, tables, t, out, B, H, ps,
                                        D, n_pg, sm_scale, s);
  if (dtype == kBF16)
    return D <= 64
               ? launch<__nv_bfloat16, 64>(q, kp, vp, tables, t, out, B, H, ps,
                                           D, n_pg, sm_scale, s)
               : launch<__nv_bfloat16, 128>(q, kp, vp, tables, t, out, B, H,
                                            ps, D, n_pg, sm_scale, s);
  return cudaErrorInvalidValue;
}
