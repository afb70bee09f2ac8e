// The attention-dropout keep mask shared by the flash forward and both
// backward kernels (flash_fwd.cu, flash_bwd.cu), and its test entry.
//
// The TPU kernels re-seed the core PRNG per (seed, flat tile id)
// (`_keep_tile`, mxnet_tpu/pallas_ops/flash_attention.py), so forward, dq
// and dkv regenerate one mask in their different loop orders. On the card
// blocks run unordered and the three kernels tile differently, so the keep
// bit of score element (bh, row, col) is keyed by its COORDINATES instead:
//
//   bits(bh, row, col) = philox4x32_10(counter = (col >> 2, row, bh, 0),
//                                      key = (seed_lo, seed_hi))[col & 3]
//   keep = bits >= threshold,  threshold = min(round(p * 2^32), 2^32 - 1)
//
// (the TPU kernel's rule `bits >= round(p * 2^32)`). One Philox call gives
// the bits of four neighbouring columns. Any tiling gives the same mask,
// and the plain version (`dropout_keep_mask` in cuda_ops/flash_attention.py)
// reproduces it bit for bit.
//
// Every kernel computes the bits in registers, in its accumulator layout,
// with no shared memory and no block barrier: the forwards and dq (the
// bf16 wgmma kernels and the float32 split-TF32 kernels on mma.sync) hold
// (query rows, key columns) tiles (`keep_quad`), dkv holds the transpose,
// (key rows, query columns) (`keep_quad_t`). Either way a lane makes one
// Philox call per 8-column block of its tile, and the lanes that share the
// call's four words swap bits with shuffles.
#pragma once

#include <stdint.h>

namespace mxt {

struct DropoutArgs {
  uint32_t seed_lo, seed_hi;
  uint32_t threshold;   // drop when bits < threshold
  float inv_keep;       // 1 / (1 - p)
  int on;               // p > 0
};

__host__ __device__ __forceinline__ void philox_round(uint32_t c[4],
                                                      uint32_t k0,
                                                      uint32_t k1) {
  const uint64_t p0 = (uint64_t)0xD2511F53u * c[0];
  const uint64_t p1 = (uint64_t)0xCD9E8D57u * c[2];
  const uint32_t hi0 = (uint32_t)(p0 >> 32), lo0 = (uint32_t)p0;
  const uint32_t hi1 = (uint32_t)(p1 >> 32), lo1 = (uint32_t)p1;
  const uint32_t n0 = hi1 ^ c[1] ^ k0;
  const uint32_t n2 = hi0 ^ c[3] ^ k1;
  c[0] = n0;
  c[1] = lo1;
  c[2] = n2;
  c[3] = lo0;
}

// Philox-4x32 with 10 rounds (Salmon et al., SC'11; Random123's constants)
__host__ __device__ __forceinline__ void philox4x32_10(uint32_t c[4],
                                                       uint32_t k0,
                                                       uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    philox_round(c, k0, k1);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
}

// keep bits of columns 4*grp .. 4*grp+3 of row `row` in head `bh`, bit j
// for column 4*grp + j
__device__ __forceinline__ uint32_t keep_nibble(const DropoutArgs& d, int bh,
                                                int row, int grp) {
  uint32_t c[4] = {(uint32_t)grp, (uint32_t)row, (uint32_t)bh, 0u};
  philox4x32_10(c, d.seed_lo, d.seed_hi);
  return (uint32_t)(c[0] >= d.threshold) |
         ((uint32_t)(c[1] >= d.threshold) << 1) |
         ((uint32_t)(c[2] >= d.threshold) << 2) |
         ((uint32_t)(c[3] >= d.threshold) << 3);
}

// Keep bits of the four accumulator entries a thread holds in one 8-column
// block of a wgmma (or mma.sync) tile: rows r0 and r1 = r0 + 8, columns col
// and col + 1, where col = 8j + 2 tig is even. Bit e of the result is entry
// e: (r0, col), (r0, col + 1), (r1, col), (r1, col + 1). The lanes tig
// 2i and 2i + 1 hold the two halves of one 4-column group: each makes one
// Philox call, for row r0 (even tig) or r1 (odd tig), and the two swap
// their nibbles with one shuffle. Every lane of the warp must call it.
__device__ __forceinline__ uint32_t keep_quad(const DropoutArgs& d, int bh,
                                              int r0, int r1, int col,
                                              int tig) {
  const bool odd = tig & 1;
  const uint32_t mine = keep_nibble(d, bh, odd ? r1 : r0, col >> 2);
  const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 1);
  const uint32_t n0 = odd ? other : mine, n1 = odd ? mine : other;
  const int co = col & 3;                // 0 or 2
  return ((n0 >> co) & 3u) | (((n1 >> co) & 3u) << 2);
}

// The same for the transposed tiles of dkv, whose accumulator rows are
// keys and columns queries. A thread holds keys kl0 = 4 g0 + u (u = gid &
// 3, g0 = kl0 >> 2) and kl1 = kl0 + 8, for queries q and q + 1 (q even).
// Bit e of the result is entry e: (kl0, q), (kl0, q + 1), (kl1, q),
// (kl1, q + 1); its keep bit is word (key & 3) of the Philox call at
// (query, key >> 2). The four lanes u = 0..3 of one tig (lanes 4 apart)
// share q and g0 and need exactly four calls between them: (q, g0),
// (q + 1, g0), (q, g0 + 2), (q + 1, g0 + 2). Lane u makes call u, and two
// shuffles hand every lane all four nibbles, of which it keeps bit u.
// Every lane of the warp must call it.
__device__ __forceinline__ uint32_t keep_quad_t(const DropoutArgs& d, int bh,
                                                int q, int g0, int u) {
  uint32_t all = keep_nibble(d, bh, q + (u & 1), g0 + 2 * (u >> 1))
                 << (4 * u);
  all |= __shfl_xor_sync(0xffffffffu, all, 4);
  all |= __shfl_xor_sync(0xffffffffu, all, 8);
  const uint32_t t = (all >> u) & 0x1111u;   // bit 4e: bit u of call e
  return (t | (t >> 3) | (t >> 6) | (t >> 9)) & 0xFu;
}

// keep_quad_t over the eight 8-query blocks of a 64-query tile, whose
// thread-held queries are q, q + 8, ..., q + 56 (q = q0 + 2 tig): bits
// 4j .. 4j + 3 for block j
__device__ __forceinline__ uint32_t keep_tile_t(const DropoutArgs& d, int bh,
                                                int q, int g0, int u) {
  uint32_t keep = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) keep |= keep_quad_t(d, bh, q + 8 * j, g0, u)
                                      << (4 * j);
  return keep;
}

}  // namespace mxt
