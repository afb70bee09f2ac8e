// Flash attention backward for Hopper (sm_90a), hand-written CUDA C++: the
// dq kernel and the dkv kernel.
//
// Replaces the TPU kernels `_dq_kernel` and `_dkv_kernel` of
// mxnet_tpu/pallas_ops/flash_attention.py (launched by `_flash_bwd_pallas`).
// With the forward's residuals (O's row log-sum-exp `lse`) and
// delta = rowsum(dO * O) (plain torch, as the JAX package computes it
// outside Pallas), each score tile is rebuilt from q and k:
//   p  = exp(q.k^T * sm_scale + bias - lse)      (causal: masked -> -1e30)
//   dp = dO.v^T, dropped and scaled by 1/(1-p) where the keep mask drops
//   ds = p * (dp - delta) * sm_scale, rounded to the input dtype
//   dq = sum_k ds.k            (dq kernel: one block per 64-row q tile)
//   dv = sum_q p~^T.dO, dk = sum_q ds^T.q
//                              (dkv kernel: one block per 64-key tile)
// where p~ is p dropped and scaled, rounded to the input dtype. The split
// into two kernels is the TPU design: each output tile is owned by one
// block, so there are no atomics and the result is deterministic. Keep bits
// are the coordinate-keyed Philox of dropout.cuh, identical to the
// forward's whatever the tiling. Ragged Lq and Lk are masked in the kernel;
// a causal dq block stops at the last key tile its rows can see, a causal
// dkv block starts at the first q tile that can see its keys (the offset
// Lk - Lq aligns the last query with the last key, as the forward does).
//
// What bounds it: about 4*Lq*Lk*D operations per kernel per (b, h) (dq: two
// products to rebuild p and dp, one for dq; dkv: two plus two) for
// ~6*L*D elements moved, so at BERT-base (L = 512, D = 64) both are bound by
// operations on the bf16 tensor cores. Two bodies, chosen by dtype, as in
// flash_fwd.cu: bfloat16 runs `mma.sync` m16n8k16 with the score
// accumulators handed to the next product's A operand in registers;
// float32 runs FMAs on the CUDA cores (TF32 would break the float32
// tolerance). wgmma, TMA and pipelined loads are later work.
#include "dropout.cuh"
#include "flash_common.cuh"

namespace mxt {
namespace {

constexpr int THREADS = 256;      // float32 bodies: 4 threads per row
constexpr int MMA_THREADS = 128;  // bf16 bodies: 4 warps x 16 rows
constexpr int PS = 64 + 4;        // padded row stride of a 64-wide f32 tile

__device__ __forceinline__ float rowdot4(const float* a, const float* b,
                                         int dmax, float acc) {
  for (int d = 0; d < dmax; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(a + d);
    const float4 y = *reinterpret_cast<const float4*>(b + d);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
    acc = fmaf(x.z, y.z, acc);
    acc = fmaf(x.w, y.w, acc);
  }
  return acc;
}

// acc[4 * i + e] += w * row[4 * (g + 4 * i) + e]: a thread's float4 groups
template <int NG>
__device__ __forceinline__ void axpy_groups(float* acc, float w,
                                            const float* row, int g) {
#pragma unroll
  for (int i = 0; i < NG; ++i) {
    const float4 x = *reinterpret_cast<const float4*>(row + 4 * (g + 4 * i));
    acc[4 * i + 0] = fmaf(w, x.x, acc[4 * i + 0]);
    acc[4 * i + 1] = fmaf(w, x.y, acc[4 * i + 1]);
    acc[4 * i + 2] = fmaf(w, x.z, acc[4 * i + 2]);
    acc[4 * i + 3] = fmaf(w, x.w, acc[4 * i + 3]);
  }
}

template <int NG, typename T>
__device__ __forceinline__ void store_groups(T* dst, const float* acc, int g,
                                             int D) {
#pragma unroll
  for (int i = 0; i < NG; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (g + 4 * i) + e;
      if (d < D) dst[d] = from_f<T>(acc[4 * i + e]);
    }
}

// ---- float32 dq -------------------------------------------------------------

template <int DMAX> struct DqSmem {
  static constexpr int SD = F32Rows<DMAX>::SD;
  static constexpr int bytes = (4 * 64 * SD + 64 * PS) * 4 + 64 * kMaskGroups;
};

template <int DMAX>
__global__ void __launch_bounds__(THREADS)
dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ bias,
              const float* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dq, int H,
              int Lq, int Lk, int D, float sm_scale, int causal,
              DropoutArgs drop) {
  constexpr int SD = DqSmem<DMAX>::SD;
  constexpr int NG = DMAX / 16;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Gs = Qs + 64 * SD;             // dO tile
  float* Ks = Gs + 64 * SD;
  float* Vs = Ks + 64 * SD;
  float* DSs = Vs + 64 * SD;
  uint8_t* Mk = reinterpret_cast<uint8_t*>(DSs + 64 * PS);

  const int bh = blockIdx.x, b = bh / H, q0 = blockIdx.y * BM;
  const int tid = threadIdx.x, row = tid >> 2, g = tid & 3;
  const int qrow = q0 + row;
  const int off = Lk - Lq;
  const float* brow = bias + (size_t)b * Lk;
  const int nq = min(BM, Lq - q0);
  load_tile_f32<DMAX, THREADS>(Qs, q + ((size_t)bh * Lq + q0) * D, nq, D);
  load_tile_f32<DMAX, THREADS>(Gs, dout + ((size_t)bh * Lq + q0) * D, nq, D);
  const float lse_r = qrow < Lq ? lse[(size_t)bh * Lq + qrow] : 0.f;
  const float delta_r = qrow < Lq ? delta[(size_t)bh * Lq + qrow] : 0.f;
  int hi = Lk;
  if (causal && off >= 0) hi = min(Lk, min(q0 + BM, Lq) + off);

  float acc[4 * NG];
#pragma unroll
  for (int i = 0; i < 4 * NG; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < hi; k0 += BN) {
    __syncthreads();                     // last tile's readers are done
    const int nk = min(BN, Lk - k0);
    load_tile_f32<DMAX, THREADS>(Ks, k + ((size_t)bh * Lk + k0) * D, nk, D);
    load_tile_f32<DMAX, THREADS>(Vs, v + ((size_t)bh * Lk + k0) * D, nk, D);
    if (drop.on) fill_tile_mask(Mk, drop, bh, q0, k0, THREADS);
    __syncthreads();

    float* dsrow = DSs + row * PS;
#pragma unroll 4
    for (int j = 0; j < 16; ++j) {
      const int cl = g + 4 * j, c = k0 + cl;
      float ds = 0.f;
      if (c < Lk) {
        float x = rowdot4(Qs + row * SD, Ks + cl * SD, DMAX, 0.f) * sm_scale +
                  brow[c];
        if (causal && c > qrow + off) x = kNeg;
        const float p = expf(x - lse_r);
        float dp = rowdot4(Gs + row * SD, Vs + cl * SD, DMAX, 0.f);
        if (drop.on) dp = tile_keep(Mk, row, cl) ? dp * drop.inv_keep : 0.f;
        ds = p * (dp - delta_r) * sm_scale;
      }
      dsrow[cl] = ds;
    }
    __syncwarp();                        // a row's ds is written by its warp
    for (int c = 0; c < nk; ++c) axpy_groups<NG>(acc, dsrow[c], Ks + c * SD, g);
  }
  if (qrow < Lq) store_groups<NG>(dq + ((size_t)bh * Lq + qrow) * D, acc, g, D);
}

// ---- float32 dk, dv ---------------------------------------------------------

template <int DMAX> struct DkvSmem {
  static constexpr int SD = F32Rows<DMAX>::SD;
  static constexpr int bytes =
      (4 * 64 * SD + 2 * 64 * PS + 2 * 64) * 4 + 64 * kMaskGroups;
};

template <int DMAX>
__global__ void __launch_bounds__(THREADS)
dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ bias,
               const float* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk,
               float* __restrict__ dv, int H, int Lq, int Lk, int D,
               float sm_scale, int causal, DropoutArgs drop) {
  constexpr int SD = DkvSmem<DMAX>::SD;
  constexpr int NG = DMAX / 16;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + 64 * SD;
  float* Qs = Vs + 64 * SD;
  float* Gs = Qs + 64 * SD;              // dO tile
  float* PTs = Gs + 64 * SD;             // p~^T (keys x queries)
  float* DSTs = PTs + 64 * PS;           // ds^T
  float* Ls = DSTs + 64 * PS;            // lse of the q tile
  float* Es = Ls + 64;                   // delta of the q tile
  uint8_t* Mk = reinterpret_cast<uint8_t*>(Es + 64);

  const int bh = blockIdx.x, b = bh / H, k0 = blockIdx.y * BN;
  const int tid = threadIdx.x, kr = tid >> 2, g = tid & 3;
  const int kcol = k0 + kr;
  const int off = Lk - Lq;
  const int nk = min(BN, Lk - k0);
  load_tile_f32<DMAX, THREADS>(Ks, k + ((size_t)bh * Lk + k0) * D, nk, D);
  load_tile_f32<DMAX, THREADS>(Vs, v + ((size_t)bh * Lk + k0) * D, nk, D);
  const float bias_k = kcol < Lk ? bias[(size_t)b * Lk + kcol] : 0.f;
  int lo = 0;
  if (causal && off >= 0) lo = max(0, k0 - off) / BM * BM;

  float dka[4 * NG], dva[4 * NG];
#pragma unroll
  for (int i = 0; i < 4 * NG; ++i) dka[i] = dva[i] = 0.f;

  for (int q0 = lo; q0 < Lq; q0 += BM) {
    __syncthreads();                     // last tile's readers are done
    const int nq = min(BM, Lq - q0);
    load_tile_f32<DMAX, THREADS>(Qs, q + ((size_t)bh * Lq + q0) * D, nq, D);
    load_tile_f32<DMAX, THREADS>(Gs, dout + ((size_t)bh * Lq + q0) * D, nq, D);
    if (tid < 64) {                      // rows past Lq get p = 0
      Ls[tid] = tid < nq ? lse[(size_t)bh * Lq + q0 + tid] : INFINITY;
      Es[tid] = tid < nq ? delta[(size_t)bh * Lq + q0 + tid] : 0.f;
    }
    if (drop.on) fill_tile_mask(Mk, drop, bh, q0, k0, THREADS);
    __syncthreads();

    float* ptrow = PTs + kr * PS;
    float* dsrow = DSTs + kr * PS;
#pragma unroll 4
    for (int j = 0; j < 16; ++j) {
      const int ql = g + 4 * j, qi = q0 + ql;
      float x = rowdot4(Ks + kr * SD, Qs + ql * SD, DMAX, 0.f) * sm_scale +
                bias_k;
      if (causal && kcol > qi + off) x = kNeg;
      const float p = expf(x - Ls[ql]);
      float dp = rowdot4(Vs + kr * SD, Gs + ql * SD, DMAX, 0.f);
      float pv = p;
      if (drop.on) {
        const bool keep = tile_keep(Mk, ql, kr);
        pv = keep ? p * drop.inv_keep : 0.f;
        dp = keep ? dp * drop.inv_keep : 0.f;
      }
      ptrow[ql] = pv;
      dsrow[ql] = p * (dp - Es[ql]) * sm_scale;
    }
    __syncwarp();                        // a key's row is written by its warp
    for (int c = 0; c < nq; ++c) {
      axpy_groups<NG>(dva, ptrow[c], Gs + c * SD, g);
      axpy_groups<NG>(dka, dsrow[c], Qs + c * SD, g);
    }
  }
  if (kcol < Lk) {
    store_groups<NG>(dk + ((size_t)bh * Lk + kcol) * D, dka, g, D);
    store_groups<NG>(dv + ((size_t)bh * Lk + kcol) * D, dva, g, D);
  }
}

// ---- bfloat16 dq on the tensor cores ---------------------------------------

template <int DMAX> struct MmaDqSmem {
  static constexpr int SK = Bf16Rows<DMAX>::SK;
  static constexpr int bytes = 4 * 64 * SK * 2 + 64 * kMaskGroups;
};

template <int DMAX>
__global__ void __launch_bounds__(MMA_THREADS)
dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const float* __restrict__ bias,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              __nv_bfloat16* __restrict__ dq, int H, int Lq, int Lk, int D,
              float sm_scale, int causal, DropoutArgs drop) {
  constexpr int SK = MmaDqSmem<DMAX>::SK;
  constexpr int KQ = DMAX / 16;
  constexpr int NO = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Gs = Qs + 64 * SK;      // dO tile
  __nv_bfloat16* Ks = Gs + 64 * SK;
  __nv_bfloat16* Vs = Ks + 64 * SK;
  uint8_t* Mk = reinterpret_cast<uint8_t*>(Vs + 64 * SK);

  const int bh = blockIdx.x, b = bh / H, q0 = blockIdx.y * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = q0 + warp * 16 + gid, r1 = r0 + 8;   // this thread's rows
  const int off = Lk - Lq;
  const float* brow = bias + (size_t)b * Lk;
  const int nq = min(BM, Lq - q0);
  load_tile_bf16<DMAX, MMA_THREADS>(Qs, q + ((size_t)bh * Lq + q0) * D, nq, D);
  load_tile_bf16<DMAX, MMA_THREADS>(Gs, dout + ((size_t)bh * Lq + q0) * D, nq,
                                    D);
  const float lse0 = r0 < Lq ? lse[(size_t)bh * Lq + r0] : 0.f;
  const float lse1 = r1 < Lq ? lse[(size_t)bh * Lq + r1] : 0.f;
  const float dl0 = r0 < Lq ? delta[(size_t)bh * Lq + r0] : 0.f;
  const float dl1 = r1 < Lq ? delta[(size_t)bh * Lq + r1] : 0.f;
  int hi = Lk;
  if (causal && off >= 0) hi = min(Lk, min(q0 + BM, Lq) + off);
  __syncthreads();

  uint32_t qf[KQ][4], gf[KQ][4];        // A fragments of this warp's rows
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) {
    load_a_frag<SK>(qf[kk], Qs, warp * 16, kk * 16);
    load_a_frag<SK>(gf[kk], Gs, warp * 16, kk * 16);
  }
  float acc[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < hi; k0 += BN) {
    __syncthreads();                     // last tile's readers are done
    const int nk = min(BN, Lk - k0);
    load_tile_bf16<DMAX, MMA_THREADS>(Ks, k + ((size_t)bh * Lk + k0) * D, nk, D);
    load_tile_bf16<DMAX, MMA_THREADS>(Vs, v + ((size_t)bh * Lk + k0) * D, nk, D);
    if (drop.on) fill_tile_mask(Mk, drop, bh, q0, k0, MMA_THREADS);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_rows_t<DMAX>(s, qf, Ks);         // q.k^T
    mma_rows_t<DMAX>(dp, gf, Vs);        // dO.v^T

    // accumulator (j, e): row e < 2 ? r0 : r1, key k0 + 8j + 2 tig + (e & 1)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = j * 8 + tig * 2 + (e & 1), c = k0 + cl;
        const int r = e < 2 ? r0 : r1;
        float ds = 0.f;
        if (c < Lk) {
          float x = s[j][e] * sm_scale + brow[c];
          if (causal && c > r + off) x = kNeg;
          const float p = expf(x - (e < 2 ? lse0 : lse1));
          float dpv = dp[j][e];
          if (drop.on)
            dpv = tile_keep(Mk, r - q0, cl) ? dpv * drop.inv_keep : 0.f;
          ds = p * (dpv - (e < 2 ? dl0 : dl1)) * sm_scale;
        }
        s[j][e] = ds;
      }
    }
    mma_acc_rows<DMAX>(acc, s, Ks);      // dq += ds (rounded to bf16) . k
  }

#pragma unroll
  for (int dt = 0; dt < NO; ++dt) {
    const int d = dt * 8 + tig * 2;      // D % 8 == 0: d < D covers d + 1
    if (d < D) {
      if (r0 < Lq)
        *reinterpret_cast<__nv_bfloat162*>(dq + ((size_t)bh * Lq + r0) * D + d) =
            __floats2bfloat162_rn(acc[dt][0], acc[dt][1]);
      if (r1 < Lq)
        *reinterpret_cast<__nv_bfloat162*>(dq + ((size_t)bh * Lq + r1) * D + d) =
            __floats2bfloat162_rn(acc[dt][2], acc[dt][3]);
    }
  }
}

// ---- bfloat16 dk, dv on the tensor cores -----------------------------------

template <int DMAX> struct MmaDkvSmem {
  static constexpr int SK = Bf16Rows<DMAX>::SK;
  static constexpr int bytes = 4 * 64 * SK * 2 + 2 * 64 * 4 + 64 * kMaskGroups;
};

// warp w owns keys k0 + 16w .. k0 + 16w + 15 and computes the transposed
// tiles S^T = k.q^T and dP^T = v.dO^T, whose accumulators are then the A
// operands of dv += p~^T.dO and dk += ds^T.q
template <int DMAX>
__global__ void __launch_bounds__(MMA_THREADS)
dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const float* __restrict__ bias,
               const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
               int H, int Lq, int Lk, int D, float sm_scale, int causal,
               DropoutArgs drop) {
  constexpr int SK = MmaDkvSmem<DMAX>::SK;
  constexpr int KQ = DMAX / 16;
  constexpr int NO = DMAX / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + 64 * SK;
  __nv_bfloat16* Qs = Vs + 64 * SK;
  __nv_bfloat16* Gs = Qs + 64 * SK;      // dO tile
  float* Ls = reinterpret_cast<float*>(Gs + 64 * SK);   // lse of the q tile
  float* Es = Ls + 64;                                  // delta of the q tile
  uint8_t* Mk = reinterpret_cast<uint8_t*>(Es + 64);

  const int bh = blockIdx.x, b = bh / H, k0 = blockIdx.y * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int kl0 = warp * 16 + gid, kl1 = kl0 + 8;      // this thread's keys
  const int off = Lk - Lq;
  const int nk = min(BN, Lk - k0);
  load_tile_bf16<DMAX, MMA_THREADS>(Ks, k + ((size_t)bh * Lk + k0) * D, nk, D);
  load_tile_bf16<DMAX, MMA_THREADS>(Vs, v + ((size_t)bh * Lk + k0) * D, nk, D);
  const float* brow = bias + (size_t)b * Lk;
  const float bk0 = k0 + kl0 < Lk ? brow[k0 + kl0] : 0.f;
  const float bk1 = k0 + kl1 < Lk ? brow[k0 + kl1] : 0.f;
  int lo = 0;
  if (causal && off >= 0) lo = max(0, k0 - off) / BM * BM;

  float dka[NO][4], dva[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  for (int q0 = lo; q0 < Lq; q0 += BM) {
    __syncthreads();                     // last tile's readers are done
    const int nq = min(BM, Lq - q0);
    load_tile_bf16<DMAX, MMA_THREADS>(Qs, q + ((size_t)bh * Lq + q0) * D, nq, D);
    load_tile_bf16<DMAX, MMA_THREADS>(Gs, dout + ((size_t)bh * Lq + q0) * D, nq,
                                      D);
    if (threadIdx.x < 64) {              // rows past Lq get p = 0
      const int t = threadIdx.x;
      Ls[t] = t < nq ? lse[(size_t)bh * Lq + q0 + t] : INFINITY;
      Es[t] = t < nq ? delta[(size_t)bh * Lq + q0 + t] : 0.f;
    }
    if (drop.on) fill_tile_mask(Mk, drop, bh, q0, k0, MMA_THREADS);
    __syncthreads();

    float st[8][4], dpt[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    {
      uint32_t af[KQ][4];
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) load_a_frag<SK>(af[kk], Ks, warp * 16, kk * 16);
      mma_rows_t<DMAX>(st, af, Qs);      // k.q^T
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) load_a_frag<SK>(af[kk], Vs, warp * 16, kk * 16);
      mma_rows_t<DMAX>(dpt, af, Gs);     // v.dO^T
    }

    // accumulator (j, e): key e < 2 ? kl0 : kl1, query q0 + 8j + 2 tig + (e & 1)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = j * 8 + tig * 2 + (e & 1);
        const int kl = e < 2 ? kl0 : kl1;
        float x = st[j][e] * sm_scale + (e < 2 ? bk0 : bk1);
        if (causal && k0 + kl > q0 + ql + off) x = kNeg;
        const float p = expf(x - Ls[ql]);
        float dp = dpt[j][e], pv = p;
        if (drop.on) {
          const bool keep = tile_keep(Mk, ql, kl);
          pv = keep ? p * drop.inv_keep : 0.f;
          dp = keep ? dp * drop.inv_keep : 0.f;
        }
        st[j][e] = pv;
        dpt[j][e] = p * (dp - Es[ql]) * sm_scale;
      }
    }
    mma_acc_rows<DMAX>(dva, st, Gs);     // dv += p~^T (rounded) . dO
    mma_acc_rows<DMAX>(dka, dpt, Qs);    // dk += ds^T (rounded) . q
  }

#pragma unroll
  for (int dt = 0; dt < NO; ++dt) {
    const int d = dt * 8 + tig * 2;
    if (d < D) {
      const int c0 = k0 + kl0, c1 = k0 + kl1;
      if (c0 < Lk) {
        *reinterpret_cast<__nv_bfloat162*>(dk + ((size_t)bh * Lk + c0) * D + d) =
            __floats2bfloat162_rn(dka[dt][0], dka[dt][1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + ((size_t)bh * Lk + c0) * D + d) =
            __floats2bfloat162_rn(dva[dt][0], dva[dt][1]);
      }
      if (c1 < Lk) {
        *reinterpret_cast<__nv_bfloat162*>(dk + ((size_t)bh * Lk + c1) * D + d) =
            __floats2bfloat162_rn(dka[dt][2], dka[dt][3]);
        *reinterpret_cast<__nv_bfloat162*>(dv + ((size_t)bh * Lk + c1) * D + d) =
            __floats2bfloat162_rn(dva[dt][2], dva[dt][3]);
      }
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *bias, *dout, *lse, *delta;
  int B, H, Lq, Lk, D;
  float sm_scale;
  int causal;
  DropoutArgs drop;
  cudaStream_t stream;
};

template <int DMAX>
cudaError_t launch_dq(const BwdArgs& a, int dtype, void* dq) {
  dim3 grid(a.B * a.H, (a.Lq + BM - 1) / BM);
  cudaError_t e;
  if (dtype == kF32) {
    static bool configured = false;
    constexpr int bytes = DqSmem<DMAX>::bytes;
    if ((e = allow_smem(dq_f32_kernel<DMAX>, bytes, configured))) return e;
    dq_f32_kernel<DMAX><<<grid, THREADS, bytes, a.stream>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        (const float*)a.bias, (const float*)a.dout, (const float*)a.lse,
        (const float*)a.delta, (float*)dq, a.H, a.Lq, a.Lk, a.D, a.sm_scale,
        a.causal, a.drop);
  } else {
    static bool configured = false;
    constexpr int bytes = MmaDqSmem<DMAX>::bytes;
    if ((e = allow_smem(dq_mma_kernel<DMAX>, bytes, configured))) return e;
    dq_mma_kernel<DMAX><<<grid, MMA_THREADS, bytes, a.stream>>>(
        (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.k,
        (const __nv_bfloat16*)a.v, (const float*)a.bias,
        (const __nv_bfloat16*)a.dout, (const float*)a.lse,
        (const float*)a.delta, (__nv_bfloat16*)dq, a.H, a.Lq, a.Lk, a.D,
        a.sm_scale, a.causal, a.drop);
  }
  return cudaGetLastError();
}

template <int DMAX>
cudaError_t launch_dkv(const BwdArgs& a, int dtype, void* dk, void* dv) {
  dim3 grid(a.B * a.H, (a.Lk + BN - 1) / BN);
  cudaError_t e;
  if (dtype == kF32) {
    static bool configured = false;
    constexpr int bytes = DkvSmem<DMAX>::bytes;
    if ((e = allow_smem(dkv_f32_kernel<DMAX>, bytes, configured))) return e;
    dkv_f32_kernel<DMAX><<<grid, THREADS, bytes, a.stream>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v,
        (const float*)a.bias, (const float*)a.dout, (const float*)a.lse,
        (const float*)a.delta, (float*)dk, (float*)dv, a.H, a.Lq, a.Lk, a.D,
        a.sm_scale, a.causal, a.drop);
  } else {
    static bool configured = false;
    constexpr int bytes = MmaDkvSmem<DMAX>::bytes;
    if ((e = allow_smem(dkv_mma_kernel<DMAX>, bytes, configured))) return e;
    dkv_mma_kernel<DMAX><<<grid, MMA_THREADS, bytes, a.stream>>>(
        (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.k,
        (const __nv_bfloat16*)a.v, (const float*)a.bias,
        (const __nv_bfloat16*)a.dout, (const float*)a.lse,
        (const float*)a.delta, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, a.H,
        a.Lq, a.Lk, a.D, a.sm_scale, a.causal, a.drop);
  }
  return cudaGetLastError();
}

bool bad_shape(int B, int H, int Lq, int Lk, int D, int dtype) {
  return D <= 0 || D > 128 || D % 8 != 0 || Lq <= 0 || Lk <= 0 || B <= 0 ||
         H <= 0 || (dtype != kF32 && dtype != kBF16);
}

}  // namespace
}  // namespace mxt

// q, dout (B,H,Lq,D), k/v (B,H,Lk,D) contiguous, dtype 0 = float32,
// 1 = bfloat16; bias (B,Lk) float32; lse, delta (B*H, Lq) float32; the
// gradient outputs like their inputs. D % 8 == 0, D <= 128. Dropout as in
// mx_flash_fwd. Each returns the CUDA error of its launch (0 on success).
extern "C" int mx_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* bias, const void* dout,
                               const void* lse, const void* delta, void* dq,
                               int B, int H, int Lq, int Lk, int D,
                               float sm_scale, int causal, int dtype,
                               uint32_t seed_lo, uint32_t seed_hi,
                               uint32_t threshold, float inv_keep,
                               int dropout_on, void* stream) {
  using namespace mxt;
  if (bad_shape(B, H, Lq, Lk, D, dtype)) return cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, bias, dout, lse, delta, B, H, Lq, Lk, D, sm_scale,
                  causal,
                  DropoutArgs{seed_lo, seed_hi, threshold, inv_keep, dropout_on},
                  static_cast<cudaStream_t>(stream)};
  return D <= 64 ? launch_dq<64>(a, dtype, dq) : launch_dq<128>(a, dtype, dq);
}

extern "C" int mx_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* bias, const void* dout,
                                const void* lse, const void* delta, void* dk,
                                void* dv, int B, int H, int Lq, int Lk, int D,
                                float sm_scale, int causal, int dtype,
                                uint32_t seed_lo, uint32_t seed_hi,
                                uint32_t threshold, float inv_keep,
                                int dropout_on, void* stream) {
  using namespace mxt;
  if (bad_shape(B, H, Lq, Lk, D, dtype)) return cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, bias, dout, lse, delta, B, H, Lq, Lk, D, sm_scale,
                  causal,
                  DropoutArgs{seed_lo, seed_hi, threshold, inv_keep, dropout_on},
                  static_cast<cudaStream_t>(stream)};
  return D <= 64 ? launch_dkv<64>(a, dtype, dk, dv)
                 : launch_dkv<128>(a, dtype, dk, dv);
}
