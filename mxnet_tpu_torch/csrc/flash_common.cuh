// The split-TF32 building blocks of the float32 flash attention bodies
// (flash_fwd.cu's forward, flash_bwd.cu's dq and dkv), all on the tensor
// cores: the tiling a block follows, cp.async tile copies into swizzled
// rows, the big/small split, and m16n8k8 TF32 mma.sync with its fragment
// offsets. (The bf16 bodies build on hopper.cuh: TMA and wgmma.)
#pragma once

#include "common.cuh"

namespace mxt {

// The tiling of a split-TF32 body. A block owns ROWS rows, 16 a warp (8
// warps at D <= 64, 4 at D <= 128): query rows in the forward and dq,
// keys in dkv. Its OWN own tensors (Q; Q and dO; K and V) stay raw in
// shared memory and are split as their A fragments load. It walks the
// other side in tiles of TR rows (keys in the forward and dq, queries in
// dkv; 64 at D <= 64 and 32 at D <= 128 unless the body asks for fewer),
// each tensor of a tile copied by cp.async into the "small" half of a
// stage, split in place by the threads that copied it, and read by every
// warp. Two stages: tile i + 1 is in flight while tile i's products run.
// A stage also carries VALS values a tile row, 4-byte copies: the key
// bias (forward, dq) or lse and delta (dkv).
template <int DMAX, int OWN, int VALS, int TR_ = DMAX == 64 ? 64 : 32>
struct F32Plan {
  static constexpr int WARPS = DMAX == 64 ? 8 : 4;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int ROWS = 16 * WARPS;
  static constexpr int TR = TR_;
  static constexpr int NT = TR / 8;          // n-tiles of a score tile
  static constexpr int ND = DMAX / 8;        // n-tiles of an output row
  static constexpr int FIXED = ROWS * DMAX;  // floats of one own tensor
  static constexpr int TILE = TR * DMAX;     // floats of one walked part
  // [first walked tensor big, small, second big, small, VALS x TR]
  static constexpr int STAGE = 4 * TILE + VALS * TR;
  static constexpr int bytes = (OWN * FIXED + 2 * STAGE) * 4;
};

// ---- split TF32 on the tensor cores ---------------------------------------
//
// A float32 x is the sum of two TF32 values: big = tf32(x) and small =
// tf32(x - big), each rounded to 10 mantissa bits, to nearest with ties
// away from zero (cvt.rna.tf32.f32's rounding, here two integer
// operations). A product a.b of float32 accuracy is then three TF32
// tensor-core products summed into float32 accumulators, the small terms
// first: a_small.b_big + a_big.b_small + a_big.b_big. The dropped
// a_small.b_small and the rounding of the small parts are below 2^-22 of
// |a b| (tests/test_torch_flash_split_tf32.py states the error in numpy).
// The tensor cores round each accumulation toward zero, so a long chain
// of products into one accumulator drifts by up to an ulp of the running
// sum a product, all one way: measured on the card, 1.6e-4 on a dq of
// |13| summed over 257 keys. So every product here sums two k-steps (six
// products) into a fresh partial whose first product starts from zero,
// and adds the partial to the accumulator with a float32 add, rounded to
// nearest: the drift is then relative to a 16-term partial.

// x rounded to TF32 (10 mantissa bits, nearest, ties away), as its bits
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d += a.b, one m16n8k8 TF32 tensor-core product (A 16 x 8 row-major, B
// 8 x 8 column-major, lane = 4 g + t): a = (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4); b = (t, g), (t + 4, g); d = (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a.b: the first product of a partial sum (C = 0)
__device__ __forceinline__ void mma_tf32_first(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

__device__ __forceinline__ void add4(float (&acc)[4], const float (&part)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += part[e];
}

// A float32 tile in shared memory: rows of DMAX floats (DMAX % 32 == 0),
// unpadded, element (r, c) at r * DMAX + (c ^ 8 ((r ^ (r >> 2)) & 3)).
// The XOR moves whole 8-float groups (so 16-byte chunks stay whole), and
// it keeps both fragment patterns of the split-TF32 products free of bank
// conflicts, for R a multiple of 8:
//  (a) lane (g, t) reads the float2 at (R + g, 8s + 2t): the A operand of
//      every product and the B operand of a score product. The
//      contraction index is permuted within each 8 (slot t is column 2t,
//      slot t + 4 column 2t + 1), the same for A and B, so a pair of
//      slots is one 8-byte load;
//  (b) lane (g, t) reads (R + 2t, 8i + g) and (R + 2t + 1, 8i + g): the B
//      operand of a gradient product, whose contraction runs over the
//      tile's rows in the order of a score accumulator's columns (slot t
//      is row 2t, slot t + 4 row 2t + 1), so a score tile is its A
//      operand as it stands in registers.
template <int DMAX>
__device__ __forceinline__ int tf32_off(int r, int c) {
  return r * DMAX + (c ^ (((r ^ (r >> 2)) & 3) << 3));
}

// A lane's offsets into such a tile for the two patterns, made once so
// that each fragment load is a register plus a constant
template <int DMAX> struct FragOffsets {
  int a[4], b[2][4];
  __device__ __forceinline__ FragOffsets(int g, int t) {
    const int wg = (g & 3) ^ (g >> 2);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      a[m] = g * DMAX + 8 * (m ^ wg) + 2 * t;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 2 * t + e;
        b[e][m] = r * DMAX + 8 * (m ^ (r & 3) ^ (r >> 2)) + g;
      }
    }
  }
  // pattern (a): the float2 at (R + g, 8s + 2t)
  __device__ __forceinline__ int a_off(int R, int s) const {
    return R * DMAX + 32 * (s >> 2) + a[(s & 3) ^ ((R >> 2) & 2)];
  }
  // pattern (b): (8j + 2t + e, 8i + g)
  __device__ __forceinline__ int b_off(int j, int e, int i) const {
    return 8 * j * DMAX + 32 * (i >> 2) + b[e][(i & 3) ^ ((j & 1) << 1)];
  }
};

// Start copying rows [0, nvalid) of a (ROWS, D) float32 tile at src into
// ROWS swizzled rows at dst, zero-filled past D and past nvalid: 16-byte
// chunk i by thread i mod NTHREADS
template <int DMAX, int NTHREADS, int ROWS>
__device__ __forceinline__ void copy_tile_async(float* dst, const float* src,
                                                int nvalid, int D) {
  constexpr int CPR = DMAX / 4;
  static_assert(ROWS * CPR % NTHREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int n = 0; n < ROWS * CPR / NTHREADS; ++n) {
    const int i = threadIdx.x + n * NTHREADS;
    const int r = i / CPR, c = (i % CPR) * 4;
    const bool ok = r < nvalid && c < D;
    cp_async16(dst + tf32_off<DMAX>(r, c), ok ? src + (size_t)r * D + c : src,
               ok ? 16 : 0);
  }
}

// Split in place the chunks this thread copied with copy_tile_async (the
// same template arguments), after cp_async_wait<0>: the raw float32
// values in `small` become their small parts, their big parts go to `big`
template <int DMAX, int NTHREADS, int ROWS>
__device__ __forceinline__ void split_tile(float* big, float* small) {
  constexpr int CPR = DMAX / 4;
#pragma unroll
  for (int n = 0; n < ROWS * CPR / NTHREADS; ++n) {
    const int i = threadIdx.x + n * NTHREADS;
    const int o = tf32_off<DMAX>(i / CPR, (i % CPR) * 4);
    const float4 x = *reinterpret_cast<const float4*>(small + o);
    uint4 hi, lo;
    split_tf32(x.x, hi.x, lo.x);
    split_tf32(x.y, hi.y, lo.y);
    split_tf32(x.z, hi.z, lo.z);
    split_tf32(x.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(big + o) = hi;
    *reinterpret_cast<uint4*>(small + o) = lo;
  }
}

// The products below run U output tiles side by side (u = 0 .. U - 1,
// two unless a caller asks for more): their six-mma chains interleave, so
// each mma waits on the one U back.

// acc[j] = A.B^T over the head dim for 16 rows of a raw tile, from `a`
// (the tile plus 16 R rows: the swizzle repeats every 16 rows) and split
// as their fragments load, and the 8 NT rows of the split tile (bb, bs):
// score columns 8j + 2t + (e & 1) in acc[j][e]. Partial sums of two
// k-steps; k-steps past D hold zeros on both sides, and pairs of them are
// skipped.
template <int DMAX, int NT, int U = 2>
__device__ __forceinline__ void score_tile(float (&acc)[NT][4], const float* a,
                                           const float* bb, const float* bs,
                                           int D,
                                           const FragOffsets<DMAX>& fo) {
  static_assert(NT % U == 0, "n-tiles go in groups of U");
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int s = 0; s < DMAX / 8; s += 2) {
    if (8 * s >= D) break;
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 x0 =
          *reinterpret_cast<const float2*>(a + fo.a_off(0, s + h));
      const float2 x1 =
          *reinterpret_cast<const float2*>(a + fo.a_off(8, s + h));
      split_tf32(x0.x, ab[h][0], as[h][0]);
      split_tf32(x1.x, ab[h][1], as[h][1]);
      split_tf32(x0.y, ab[h][2], as[h][2]);
      split_tf32(x1.y, ab[h][3], as[h][3]);
    }
#pragma unroll
    for (int j = 0; j < NT; j += U) {
      uint2 xb[U][2], xs[U][2];              // [u][h]
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = fo.a_off(8 * (j + u), s + h);
          xb[u][h] = *reinterpret_cast<const uint2*>(bb + o);
          xs[u][h] = *reinterpret_cast<const uint2*>(bs + o);
        }
      float part[U][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (h == 0)
            mma_tf32_first(part[u], as[h], xb[u][h].x, xb[u][h].y);
          else
            mma_tf32(part[u], as[h], xb[u][h].x, xb[u][h].y);
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          mma_tf32(part[u], ab[h], xs[u][h].x, xs[u][h].y);
#pragma unroll
        for (int u = 0; u < U; ++u)
          mma_tf32(part[u], ab[h], xb[u][h].x, xb[u][h].y);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) add4(acc[j + u], part[u]);
    }
  }
}

// acc[i] += P.B: P the 16 x 8 NT score tile p (as score_tile leaves it),
// B the split tile (bb, bs) of 8 NT rows, whose rows are the contraction;
// head-dim columns 8i + 2t + (e & 1) of acc[i][e]. Partial sums of two
// k-steps (16 rows); groups of U n-tiles past D are skipped (the rest of
// a group that starts below D reads the tile's zeros).
template <int DMAX, int NT, int U = 2>
__device__ __forceinline__ void grad_tile(float (&acc)[DMAX / 8][4],
                                          const float (&p)[NT][4],
                                          const float* bb, const float* bs,
                                          int D, const FragOffsets<DMAX>& fo) {
  static_assert(NT % 2 == 0, "k-steps go in pairs");
  const uint32_t* ub = reinterpret_cast<const uint32_t*>(bb);
  const uint32_t* us = reinterpret_cast<const uint32_t*>(bs);
#pragma unroll
  for (int j = 0; j < NT; j += 2) {
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      split_tf32(p[j + h][0], ab[h][0], as[h][0]);   // (g, row 2t)
      split_tf32(p[j + h][2], ab[h][1], as[h][1]);   // (g + 8, row 2t)
      split_tf32(p[j + h][1], ab[h][2], as[h][2]);   // (g, row 2t + 1)
      split_tf32(p[j + h][3], ab[h][3], as[h][3]);   // (g + 8, row 2t + 1)
    }
#pragma unroll
    for (int i = 0; i < DMAX / 8; i += U) {
      if (8 * i >= D) break;
      uint32_t xb[U][2][2], xs[U][2][2];     // [u][h][row 2t, 2t + 1]
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = fo.b_off(j + h, e, i + u);
            xb[u][h][e] = ub[o];
            xs[u][h][e] = us[o];
          }
      float part[U][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (h == 0)
            mma_tf32_first(part[u], as[h], xb[u][h][0], xb[u][h][1]);
          else
            mma_tf32(part[u], as[h], xb[u][h][0], xb[u][h][1]);
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          mma_tf32(part[u], ab[h], xs[u][h][0], xs[u][h][1]);
#pragma unroll
        for (int u = 0; u < U; ++u)
          mma_tf32(part[u], ab[h], xb[u][h][0], xb[u][h][1]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) add4(acc[i + u], part[u]);
    }
  }
}

}  // namespace mxt
