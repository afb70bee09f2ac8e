// Flash attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `_fwd_kernel` of
// mxnet_tpu/pallas_ops/flash_attention.py (launched by `_flash_fwd_pallas`):
// scores = q.k^T * sm_scale + bias[b, key], then the causal
// mask aligned so the last query sees the last key (offset Lk - Lq; masked
// scores are REPLACED by -1e30), an online softmax with a running max and
// denominator in float32, P rounded to the model dtype before P.V, and the
// output O (in q's dtype) plus the row log-sum-exp (float32), which the
// backward kernels (flash_bwd.cu) read. Attention dropout follows the TPU
// kernel exactly: the denominator l and the LSE sum the UNDROPPED p; only
// the P.V accumulation sees the kept p scaled by 1/(1-p). The keep bits
// come from the coordinate-keyed Philox of dropout.cuh, filled into shared
// memory once per tile.
//
// What bounds it: a causal pass does about 2*L^2*D operations per (b, h)
// for 4*L*D elements moved. Against the card's bf16 tensor-core rate that
// is bound by bytes up to L of about 1,200 at D = 64 (128 operations per
// byte at L = 512, against the ~295 the card needs) and by operations
// beyond. The design keeps the L x L score matrix out of device memory,
// as the TPU kernel does: one block per (b*h, 64-row q tile) holds its q
// tile in shared memory and walks the key axis in 64-row K/V tiles, each
// staged with 16-byte loads; a causal tile stops at the last key its last
// row can see. Ragged Lq and Lk are masked in the kernel (keys past Lk get
// zero weight), so nothing is padded.
//
// Two bodies, chosen by dtype:
//  * bfloat16 (the serving dtype) runs on the tensor cores: 4 warps, each
//    owning 16 query rows, `mma.sync` m16n8k16 with float32 accumulation;
//    fragments come from shared memory by `ldmatrix` (transposed for V),
//    and P goes from the score accumulators straight into the A operand of
//    P.V without a trip through shared memory. wgmma with TMA and
//    pipelined loads are queued in ROADMAP.md.
//  * float32 has no tensor-core path of float32 precision (TF32 keeps 10
//    mantissa bits), so it runs float32 FMAs on the CUDA cores: 256 threads,
//    thread (row = tid/4, g = tid%4) owns score columns g + 4j of its row
//    and the output float4 groups g + 4i.
// In both, the threads that share a row are neighbouring lanes, so row max
// and row sum are two shuffles.
#include "dropout.cuh"
#include "flash_common.cuh"

namespace mxt {
namespace {

constexpr int THREADS = 256;
constexpr int PS = BN + 4;    // padded row stride of the P tile

// ---- float32 on the CUDA cores ----------------------------------------------

template <int DMAX> struct Smem {
  static constexpr int SD = F32Rows<DMAX>::SD;
  static constexpr int floats = BM * SD + 2 * BN * SD + BM * PS;
  static constexpr int bytes = floats * 4 + BM * kMaskGroups;  // + keep mask
};

template <int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ o, float* __restrict__ lse, int H, int Lq,
                 int Lk, int D, float sm_scale, int causal, DropoutArgs drop) {
  constexpr int SD = Smem<DMAX>::SD;
  constexpr int NJ = BN / 4;       // score columns per thread
  constexpr int NG = DMAX / 16;    // output float4 groups per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + BM * SD;
  float* Vs = Ks + BN * SD;
  float* Ps = Vs + BN * SD;
  uint8_t* Mk = reinterpret_cast<uint8_t*>(Ps + BM * PS);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int row = tid >> 2, g = tid & 3;
  const int qrow = q0 + row;
  const int off = Lk - Lq;                 // causal alignment offset
  const float* kb = k + (size_t)bh * Lk * D;
  const float* vb = v + (size_t)bh * Lk * D;
  const float* brow = bias + (size_t)b * Lk;

  load_tile_f32<DMAX, THREADS>(Qs, q + ((size_t)bh * Lq + q0) * D,
                               min(BM, Lq - q0), D);

  // a causal tile stops at the last key its last real row sees; with
  // Lq > Lk some rows see no key and average over all of them (the
  // reference's fully-masked-row semantics), so the loop then runs full
  int hi = Lk;
  if (causal && off >= 0) hi = min(Lk, min(q0 + BM, Lq) + off);

  float acc[4 * NG];
#pragma unroll
  for (int i = 0; i < 4 * NG; ++i) acc[i] = 0.f;
  float m = kNeg, l = 0.f;

  for (int k0 = 0; k0 < hi; k0 += BN) {
    __syncthreads();                       // last tile's readers are done
    const int nk = min(BN, Lk - k0);
    load_tile_f32<DMAX, THREADS>(Ks, kb + (size_t)k0 * D, nk, D);
    load_tile_f32<DMAX, THREADS>(Vs, vb + (size_t)k0 * D, nk, D);
    if (drop.on) fill_tile_mask(Mk, drop, bh, q0, k0, THREADS);
    __syncthreads();

    float s[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j] = 0.f;
    const float* qr = Qs + row * SD;
#pragma unroll 2
    for (int d = 0; d < DMAX; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qr + d);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(Ks + (g + 4 * j) * SD + d);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }

    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = k0 + g + 4 * j;
      float x;
      if (c >= Lk) {
        x = -INFINITY;                     // past the keys: zero weight
      } else {
        x = s[j] * sm_scale + brow[c];
        if (causal && c > qrow + off) x = kNeg;
      }
      s[j] = x;
      mt = fmaxf(mt, x);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float ls = 0.f;
    float* prow = Ps + row * PS;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float p = expf(s[j] - m_new);
      ls += p;                             // the denominator sums unrounded p
      prow[g + 4 * j] =                    // P.V sees the kept, scaled p
          drop.on ? (tile_keep(Mk, row, g + 4 * j) ? p * drop.inv_keep : 0.f)
                  : p;
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    l = l * alpha + ls;
    m = m_new;
#pragma unroll
    for (int i = 0; i < 4 * NG; ++i) acc[i] *= alpha;
    __syncwarp();                          // a row's P is written by its warp

    for (int c = 0; c < nk; ++c) {
      const float p = prow[c];
      const float* vr = Vs + c * SD;
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const float4 vv = *reinterpret_cast<const float4*>(vr + 4 * (g + 4 * i));
        acc[4 * i + 0] = fmaf(p, vv.x, acc[4 * i + 0]);
        acc[4 * i + 1] = fmaf(p, vv.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(p, vv.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(p, vv.w, acc[4 * i + 3]);
      }
    }
  }

  if (qrow < Lq) {
    l = fmaxf(l, 1e-30f);
    float* orow = o + ((size_t)bh * Lq + qrow) * D;
#pragma unroll
    for (int i = 0; i < NG; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 4 * (g + 4 * i) + e;
        if (d < D) orow[d] = acc[4 * i + e] / l;
      }
    }
    if (g == 0) lse[(size_t)bh * Lq + qrow] = m + logf(l);
  }
}

template <int DMAX>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const void* bias, void* o, void* lse, int B, int H,
                       int Lq, int Lk, int D, float sm_scale, int causal,
                       const DropoutArgs& drop, cudaStream_t stream) {
  constexpr int bytes = Smem<DMAX>::bytes;
  static bool configured = false;          // above 48 KB needs an opt-in
  cudaError_t e = allow_smem(flash_fwd_kernel<DMAX>, bytes, configured);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, (Lq + BM - 1) / BM);
  flash_fwd_kernel<DMAX><<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<float*>(o), static_cast<float*>(lse), H, Lq, Lk, D, sm_scale,
      causal, drop);
  return cudaGetLastError();
}

// ---- bfloat16 on the tensor cores ----------------------------------------

constexpr int MMA_THREADS = 128;   // 4 warps x 16 query rows

template <int DMAX> struct MmaSmem {
  static constexpr int SK = Bf16Rows<DMAX>::SK;
  static constexpr int bytes = (BM + 2 * BN) * SK * 2 + BM * kMaskGroups;
};

template <int DMAX>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int H, int Lq, int Lk, int D, float sm_scale, int causal,
                     DropoutArgs drop) {
  constexpr int SK = MmaSmem<DMAX>::SK;
  constexpr int NT = BN / 8;       // score n-tiles of 8 keys
  constexpr int KQ = DMAX / 16;    // k-steps over the head dim
  constexpr int NO = DMAX / 8;     // output n-tiles of 8 dims
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BM * SK;
  __nv_bfloat16* Vs = Ks + BN * SK;
  uint8_t* Mk = reinterpret_cast<uint8_t*>(Vs + BN * SK);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int q0 = blockIdx.y * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = q0 + warp * 16 + gid, r1 = r0 + 8;   // this thread's rows
  const int off = Lk - Lq;
  const __nv_bfloat16* kb = k + (size_t)bh * Lk * D;
  const __nv_bfloat16* vb = v + (size_t)bh * Lk * D;
  const float* brow = bias + (size_t)b * Lk;

  load_tile_bf16<DMAX, MMA_THREADS>(Qs, q + ((size_t)bh * Lq + q0) * D,
                                    min(BM, Lq - q0), D);
  int hi = Lk;
  if (causal && off >= 0) hi = min(Lk, min(q0 + BM, Lq) + off);
  __syncthreads();

  uint32_t qf[KQ][4];              // A fragments of this warp's 16 rows
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) load_a_frag<SK>(qf[kk], Qs, warp * 16, kk * 16);

  float oacc[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
    oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < hi; k0 += BN) {
    __syncthreads();                       // last tile's readers are done
    const int nk = min(BN, Lk - k0);
    load_tile_bf16<DMAX, MMA_THREADS>(Ks, kb + (size_t)k0 * D, nk, D);
    load_tile_bf16<DMAX, MMA_THREADS>(Vs, vb + (size_t)k0 * D, nk, D);
    if (drop.on) fill_tile_mask(Mk, drop, bh, q0, k0, MMA_THREADS);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_rows_t<DMAX>(s, qf, Ks);

    // accumulator (j, e): row e < 2 ? r0 : r1, key k0 + 8j + 2 tig + (e & 1)
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = k0 + j * 8 + tig * 2 + (e & 1);
        float x;
        if (c >= Lk) {
          x = -INFINITY;                   // past the keys: zero weight
        } else {
          x = s[j][e] * sm_scale + brow[c];
          if (causal && c > (e < 2 ? r0 : r1) + off) x = kNeg;
        }
        s[j][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = expf(s[j][e] - (e < 2 ? mn0 : mn1));
        s[j][e] = pe;                      // the denominator sums unrounded p
        if (e < 2) ls0 += pe; else ls1 += pe;
      }
    }
    ls0 += __shfl_xor_sync(0xffffffffu, ls0, 1);
    ls0 += __shfl_xor_sync(0xffffffffu, ls0, 2);
    ls1 += __shfl_xor_sync(0xffffffffu, ls1, 1);
    ls1 += __shfl_xor_sync(0xffffffffu, ls1, 2);
    l0 = l0 * a0 + ls0;
    l1 = l1 * a1 + ls1;
    m0 = mn0;
    m1 = mn1;
    if (drop.on) {                         // P.V sees the kept, scaled p
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = warp * 16 + gid + (e < 2 ? 0 : 8);
          s[j][e] = tile_keep(Mk, r, j * 8 + tig * 2 + (e & 1))
                        ? s[j][e] * drop.inv_keep : 0.f;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      oacc[i][0] *= a0;
      oacc[i][1] *= a0;
      oacc[i][2] *= a1;
      oacc[i][3] *= a1;
    }

    // O += P V: the score accumulators of key tiles 2kk, 2kk+1 are the A
    // fragment of key step kk, rounded to bf16 on the way
    mma_acc_rows<DMAX>(oacc, s, Vs);
  }

  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int dt = 0; dt < NO; ++dt) {
    const int d = dt * 8 + tig * 2;        // D % 8 == 0: d < D covers d + 1
    if (d < D) {
      if (r0 < Lq)
        *reinterpret_cast<__nv_bfloat162*>(o + ((size_t)bh * Lq + r0) * D + d) =
            __floats2bfloat162_rn(oacc[dt][0] / l0, oacc[dt][1] / l0);
      if (r1 < Lq)
        *reinterpret_cast<__nv_bfloat162*>(o + ((size_t)bh * Lq + r1) * D + d) =
            __floats2bfloat162_rn(oacc[dt][2] / l1, oacc[dt][3] / l1);
    }
  }
  if (tig == 0) {
    if (r0 < Lq) lse[(size_t)bh * Lq + r0] = m0 + logf(l0);
    if (r1 < Lq) lse[(size_t)bh * Lq + r1] = m1 + logf(l1);
  }
}

template <int DMAX>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* bias, void* o, void* lse, int B, int H,
                       int Lq, int Lk, int D, float sm_scale, int causal,
                       const DropoutArgs& drop, cudaStream_t stream) {
  constexpr int bytes = MmaSmem<DMAX>::bytes;
  static bool configured = false;          // above 48 KB needs an opt-in
  cudaError_t e = allow_smem(flash_fwd_mma_kernel<DMAX>, bytes, configured);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, (Lq + BM - 1) / BM);
  flash_fwd_mma_kernel<DMAX><<<grid, MMA_THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), H, Lq, Lk, D,
      sm_scale, causal, drop);
  return cudaGetLastError();
}

}  // namespace
}  // namespace mxt

// q (B,H,Lq,D), k/v (B,H,Lk,D) contiguous, dtype 0 = float32, 1 = bfloat16;
// bias (B,Lk) float32; o like q; lse (B*H, Lq) float32. D % 8 == 0, D <= 128.
// Dropout (p > 0 when dropout_on): keep where Philox bits >= threshold,
// kept p scaled by inv_keep (dropout.cuh). Returns the CUDA error of the
// launch (0 on success).
extern "C" int mx_flash_fwd(const void* q, const void* k, const void* v,
                            const void* bias, void* o, void* lse, int B, int H,
                            int Lq, int Lk, int D, float sm_scale, int causal,
                            int dtype, uint32_t seed_lo, uint32_t seed_hi,
                            uint32_t threshold, float inv_keep, int dropout_on,
                            void* stream) {
  using namespace mxt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= 0 || D > 128 || D % 8 != 0 || Lq <= 0 || Lk <= 0)
    return cudaErrorInvalidValue;
  const DropoutArgs drop{seed_lo, seed_hi, threshold, inv_keep, dropout_on};
  if (dtype == kF32) {
    return D <= 64 ? launch_f32<64>(q, k, v, bias, o, lse, B, H, Lq, Lk, D,
                                    sm_scale, causal, drop, s)
                   : launch_f32<128>(q, k, v, bias, o, lse, B, H, Lq, Lk, D,
                                     sm_scale, causal, drop, s);
  }
  if (dtype == kBF16) {
    return D <= 64 ? launch_mma<64>(q, k, v, bias, o, lse, B, H, Lq, Lk, D,
                                    sm_scale, causal, drop, s)
                   : launch_mma<128>(q, k, v, bias, o, lse, B, H, Lq, Lk, D,
                                     sm_scale, causal, drop, s);
  }
  return cudaErrorInvalidValue;
}

namespace {

__global__ void dropout_mask_kernel(uint8_t* __restrict__ out, int Lq, int Lk,
                                    mxt::DropoutArgs drop) {
  const int bh = blockIdx.z;
  const int r = blockIdx.y;
  const int grp = blockIdx.x * blockDim.x + threadIdx.x;
  if (4 * grp >= Lk) return;
  const uint32_t nib = mxt::keep_nibble(drop, bh, r, grp);
  uint8_t* row = out + ((size_t)bh * Lq + r) * Lk;
  for (int j = 0; j < 4 && 4 * grp + j < Lk; ++j)
    row[4 * grp + j] = (nib >> j) & 1;
}

}  // namespace

// The keep mask itself, (BH, Lq, Lk) uint8 (1 = keep), from the same device
// function the attention kernels use: lets a test hold the kernels' mask
// against the plain version bit for bit. Not on any model path.
extern "C" int mx_dropout_mask(void* out, int BH, int Lq, int Lk,
                               uint32_t seed_lo, uint32_t seed_hi,
                               uint32_t threshold, void* stream) {
  if (BH <= 0 || Lq <= 0 || Lk <= 0 || BH > 65535 || Lq > 65535)
    return cudaErrorInvalidValue;
  const mxt::DropoutArgs drop{seed_lo, seed_hi, threshold, 1.f, 1};
  const int groups = (Lk + 3) / 4;
  dim3 grid((groups + 127) / 128, Lq, BH);
  dropout_mask_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint8_t*>(out), Lq, Lk, drop);
  return cudaGetLastError();
}
