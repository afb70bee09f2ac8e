// Tiles and tensor-core helpers shared by the flash attention kernels
// (flash_fwd.cu, flash_bwd.cu): 64-row tiles staged in shared memory with
// 16-byte loads, `ldmatrix` fragment loads and `mma.sync` m16n8k16 (bf16 in,
// float32 accumulate).
#pragma once

#include "common.cuh"

namespace mxt {

constexpr int BM = 64;        // query rows per tile
constexpr int BN = 64;        // keys per tile

// padded shared-memory row strides: float32 rows of DMAX + 4 floats keep
// float4 rows 16-byte aligned; bf16 rows of DMAX + 8 put the 8 rows an
// ldmatrix reads on distinct banks
template <int DMAX> struct F32Rows { static constexpr int SD = DMAX + 4; };
template <int DMAX> struct Bf16Rows { static constexpr int SK = DMAX + 8; };

// rows [0, nvalid) of a (rows, D) float tile into 64 smem rows of stride
// SD, zero-filled past D (up to DMAX) and past nvalid
template <int DMAX, int NTHREADS>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int nvalid, int D) {
  constexpr int VPR = DMAX / 4;
  constexpr int SD = F32Rows<DMAX>::SD;
  for (int i = threadIdx.x; i < 64 * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nvalid && c < D)
      val = *reinterpret_cast<const float4*>(src + (size_t)r * D + c);
    *reinterpret_cast<float4*>(dst + r * SD + c) = val;
  }
}

// the same for a bf16 tile into rows of stride SK
template <int DMAX, int NTHREADS>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               int nvalid, int D) {
  constexpr int VPR = DMAX / 8;
  constexpr int SK = Bf16Rows<DMAX>::SK;
  for (int i = threadIdx.x; i < 64 * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < nvalid && c < D)
      val = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
    *reinterpret_cast<uint4*>(dst + r * SK + c) = val;
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), float32 accumulate
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16 rows x 16 cols) of rows row0.. of a bf16 smem tile, at
// column k0 (`ldmatrix` row addresses: lanes 0-15 rows, lanes 16-31 the
// right 8 columns)
template <int SK>
__device__ __forceinline__ void load_a_frag(uint32_t a[4],
                                            const __nv_bfloat16* tile,
                                            int row0, int k0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(a, tile + (row0 + (lane & 15)) * SK + k0 + (lane >> 4) * 8);
}

// acc[j] (j < 64 / 8) += A (16 x DMAX, k fragments a[kk]) . B^T where B is
// 64 rows of a bf16 smem tile (keys as columns of the product): the S = Q K^T
// shape of every score tile
template <int DMAX>
__device__ __forceinline__ void mma_rows_t(float acc[8][4],
                                           const uint32_t (*a)[4],
                                           const __nv_bfloat16* tile) {
  constexpr int SK = Bf16Rows<DMAX>::SK;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < DMAX / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t bf[4];                      // B fragments of row tiles j, j+1
      ldmatrix_x4(bf, tile + ((j + (lane >> 4)) * 8 + (lane & 7)) * SK +
                          kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(acc[j], a[kk], bf[0], bf[1]);
      mma_bf16(acc[j + 1], a[kk], bf[2], bf[3]);
    }
  }
}

// out[dt] (dt < DMAX / 8) += P (16 x 64, the float accumulators p[8][4] of
// an S-shaped product, rounded to bf16) . T where T is a 64 x DMAX bf16
// smem tile (the P.V shape)
template <int DMAX>
__device__ __forceinline__ void mma_acc_rows(float (*out)[4],
                                             const float p[8][4],
                                             const __nv_bfloat16* tile) {
  constexpr int SK = Bf16Rows<DMAX>::SK;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t pa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dt = 0; dt < DMAX / 8; dt += 2) {
      uint32_t vf[4];                      // B fragments of dim tiles dt, dt+1
      ldmatrix_x4_trans(vf, tile + (kk * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * SK +
                                (dt + (lane >> 4)) * 8);
      mma_bf16(out[dt], pa, vf[0], vf[1]);
      mma_bf16(out[dt + 1], pa, vf[2], vf[3]);
    }
  }
}

// opt a kernel into more than 48 KB of dynamic shared memory, once
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) configured = true;
  return e;
}

}  // namespace mxt
