// Tiles shared by the float32 flash attention bodies (flash_fwd.cu,
// flash_bwd.cu): 64-row tiles staged in shared memory with 16-byte loads.
// (The bf16 bodies build on hopper.cuh: TMA and wgmma.)
#pragma once

#include "common.cuh"

namespace mxt {

constexpr int BM = 64;        // query rows per tile
constexpr int BN = 64;        // keys per tile

// padded shared-memory row stride of a float32 tile: rows of DMAX + 4
// floats keep float4 rows 16-byte aligned
template <int DMAX> struct F32Rows { static constexpr int SD = DMAX + 4; };

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

}  // namespace mxt
