// Int8 GEMM with the per-channel rescale, bias and relu fused into its
// epilogue, for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the TPU kernel `_kernel` of mxnet_tpu/pallas_ops/int8_matmul.py
// (launched by `_int8_matmul_pallas` from `int8_matmul`, which every
// `QuantizedDense` of a quantized model calls). It computes
//   out[m, o] = relu?( float(sum_k x[m, k] * w[k, o]) * s[o] + b[o] )
// with x (M, K) int8 row-major, w (K, O) int8 row-major (the JAX package's
// pre-transposed weight layout, kept so parameter names and shapes match),
// s = x_scale * w_scale and b (O,) float32, out (M, O) float32. The int32
// accumulator never leaves the registers, as on the TPU it never left VMEM.
// It is exact: |acc| <= 127^2 * K < 2^31 for K < 133,000.
//
// Tensor cores: `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32`. Each
// block stages a BM x BK tile of x and a BK x BN tile of w in shared memory
// and loops over K. The B fragment of m16n8k32 wants 4 consecutive k of one
// column in a 32-bit register, but w is k-major, and `ldmatrix.trans` has
// no 8-bit form. So the loader reads w as 4x4 byte blocks (4 k-rows of 4
// columns, one 32-bit word a row), transposes each block in registers with
// `__byte_perm` and stores it n-major (Bt[n][k]); fragments are then single
// 32-bit shared-memory reads. Rows are padded by 16 bytes, which keeps the
// fragment reads free of bank conflicts. Edges are predicated (zeros are
// loaded past M, K and O; nothing is padded in HBM), so any M, K, O work.
//
// The epilogue is `__fadd_rn(__fmul_rn(__int2float_rn(acc), s[o]), b[o])`:
// explicit rounding intrinsics keep nvcc from contracting the multiply and
// add into one FMA, so the output equals the plain version's separate
// float32 multiply and add bit for bit.
//
// What bounds it: at decode (M = 8) the bytes of w, K*O; at M = 1024 the
// int8 operations, 2*M*K*O over the 1,979 TOP/s dense int8 peak. Two tile
// shapes: M <= 16 takes 16 x 32 tiles with BK = 256 (more blocks over O,
// 16 loads in flight per thread); larger M takes 64 x 64 tiles with
// BK = 128 and 4 warps of 32 x 32. Loads are synchronous (no cp.async or
// TMA pipeline) and the product is mma.sync, not wgmma: a first, simple
// kernel.
#include "common.cuh"

namespace mxt {
namespace {

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a,
                                       const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned pack_bytes(const int8_t* p, int n) {
  unsigned u = 0;
  for (int j = 0; j < n; ++j) u |= (unsigned)(uint8_t)p[j] << (8 * j);
  return u;
}

template <int BM, int BN, int BK, int WM, int WN>
struct Tile {
  static constexpr int kWarpsN = BN / WN;
  static constexpr int kThreads = 32 * (BM / WM) * kWarpsN;
  static constexpr int kMT = WM / 16, kNT = WN / 8;
  static constexpr int kLds = BK + 16;              // bytes per smem row
};

template <int BM, int BN, int BK, int WM, int WN>
__global__ void __launch_bounds__(Tile<BM, BN, BK, WM, WN>::kThreads)
int8_gemm_kernel(const int8_t* __restrict__ X, const int8_t* __restrict__ W,
                 const float* __restrict__ S, const float* __restrict__ Bias,
                 float* __restrict__ Out, int M, int K, int O, int x_vec,
                 int w_vec, int relu) {
  using T = Tile<BM, BN, BK, WM, WN>;
  constexpr int LDS = T::kLds;
  __shared__ __align__(16) int8_t As[BM * LDS];    // As[m][k]
  __shared__ __align__(16) int8_t Bt[BN * LDS];    // Bt[n][k]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp / T::kWarpsN) * WM, wn = (warp % T::kWarpsN) * WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[T::kMT][T::kNT][4];
#pragma unroll
  for (int i = 0; i < T::kMT; ++i)
#pragma unroll
    for (int j = 0; j < T::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: 16-byte chunks of rows
    for (int c = tid; c < BM * BK / 16; c += T::kThreads) {
      const int r = c / (BK / 16), kc = (c % (BK / 16)) * 16;
      const int gm = m0 + r, gk = k0 + kc;
      uint4 u = make_uint4(0, 0, 0, 0);
      if (gm < M && gk < K) {
        const int8_t* src = X + (size_t)gm * K + gk;
        if (x_vec) {
          u = *reinterpret_cast<const uint4*>(src);
        } else {
          const int n = K - gk < 16 ? K - gk : 16;
          u.x = pack_bytes(src, n < 4 ? n : 4);
          if (n > 4) u.y = pack_bytes(src + 4, n - 4 < 4 ? n - 4 : 4);
          if (n > 8) u.z = pack_bytes(src + 8, n - 8 < 4 ? n - 8 : 4);
          if (n > 12) u.w = pack_bytes(src + 12, n - 12);
        }
      }
      *reinterpret_cast<uint4*>(As + r * LDS + kc) = u;
    }
    // w tile: 4x4 byte blocks, transposed into Bt[n][k]
    for (int b = tid; b < (BK / 4) * (BN / 4); b += T::kThreads) {
      const int nb = (b % (BN / 4)) * 4, kb = (b / (BN / 4)) * 4;
      const int gn = n0 + nb;
      unsigned r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int gk = k0 + kb + i;
        r[i] = 0;
        if (gk < K && gn < O) {
          const int8_t* src = W + (size_t)gk * O + gn;
          r[i] = w_vec ? *reinterpret_cast<const unsigned*>(src)
                       : pack_bytes(src, O - gn < 4 ? O - gn : 4);
        }
      }
      const unsigned t0 = __byte_perm(r[0], r[1], 0x5140);
      const unsigned t1 = __byte_perm(r[2], r[3], 0x5140);
      const unsigned t2 = __byte_perm(r[0], r[1], 0x7362);
      const unsigned t3 = __byte_perm(r[2], r[3], 0x7362);
      *reinterpret_cast<unsigned*>(Bt + (nb + 0) * LDS + kb) =
          __byte_perm(t0, t1, 0x5410);
      *reinterpret_cast<unsigned*>(Bt + (nb + 1) * LDS + kb) =
          __byte_perm(t0, t1, 0x7632);
      *reinterpret_cast<unsigned*>(Bt + (nb + 2) * LDS + kb) =
          __byte_perm(t2, t3, 0x5410);
      *reinterpret_cast<unsigned*>(Bt + (nb + 3) * LDS + kb) =
          __byte_perm(t2, t3, 0x7632);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned a[T::kMT][4], bf[T::kNT][2];
#pragma unroll
      for (int i = 0; i < T::kMT; ++i) {
        const int8_t* p = As + (wm + i * 16 + g) * LDS + kk + 4 * t;
        a[i][0] = *reinterpret_cast<const unsigned*>(p);
        a[i][1] = *reinterpret_cast<const unsigned*>(p + 8 * LDS);
        a[i][2] = *reinterpret_cast<const unsigned*>(p + 16);
        a[i][3] = *reinterpret_cast<const unsigned*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < T::kNT; ++j) {
        const int8_t* p = Bt + (wn + j * 8 + g) * LDS + kk + 4 * t;
        bf[j][0] = *reinterpret_cast<const unsigned*>(p);
        bf[j][1] = *reinterpret_cast<const unsigned*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < T::kMT; ++i)
#pragma unroll
        for (int j = 0; j < T::kNT; ++j) mma_s8(acc[i][j], a[i], bf[j]);
    }
    __syncthreads();
  }

  // epilogue: c0, c1 at row g, columns 2t, 2t+1; c2, c3 at row g + 8
#pragma unroll
  for (int i = 0; i < T::kMT; ++i)
#pragma unroll
    for (int j = 0; j < T::kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm + i * 16 + g + (e >= 2 ? 8 : 0);
        const int col = n0 + wn + j * 8 + 2 * t + (e & 1);
        if (row < M && col < O) {
          float v = __fmul_rn(__int2float_rn(acc[i][j][e]), S[col]);
          if (Bias != nullptr) v = __fadd_rn(v, Bias[col]);
          if (relu) v = v > 0.f ? v : 0.f;
          Out[(size_t)row * O + col] = v;
        }
      }
}

template <int BM, int BN, int BK, int WM, int WN>
void launch(const int8_t* X, const int8_t* W, const float* S, const float* B,
            float* Out, int M, int K, int O, int x_vec, int w_vec, int relu,
            cudaStream_t stream) {
  using T = Tile<BM, BN, BK, WM, WN>;
  const dim3 grid((O + BN - 1) / BN, (M + BM - 1) / BM);
  int8_gemm_kernel<BM, BN, BK, WM, WN><<<grid, T::kThreads, 0, stream>>>(
      X, W, S, B, Out, M, K, O, x_vec, w_vec, relu);
}

}  // namespace
}  // namespace mxt

// X (M, K) int8, W (K, O) int8, S (O,) float32 combined scales, Bias (O,)
// float32 or null, Out (M, O) float32; all contiguous. x_vec: X is 16-byte
// aligned and K % 16 == 0; w_vec: W is 4-byte aligned and O % 4 == 0.
// Returns the CUDA error of the launch.
extern "C" int mx_int8_matmul(const void* X, const void* W, const void* S,
                              const void* Bias, void* Out, int M, int K, int O,
                              int x_vec, int w_vec, int relu, void* stream) {
  using namespace mxt;
  if (M <= 0 || K <= 0 || O <= 0) return cudaErrorInvalidValue;
  const int8_t* x = static_cast<const int8_t*>(X);
  const int8_t* w = static_cast<const int8_t*>(W);
  const float* s = static_cast<const float*>(S);
  const float* b = static_cast<const float*>(Bias);
  float* out = static_cast<float*>(Out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 16)
    launch<16, 32, 256, 16, 8>(x, w, s, b, out, M, K, O, x_vec, w_vec, relu,
                               st);
  else
    launch<64, 64, 128, 32, 32>(x, w, s, b, out, M, K, O, x_vec, w_vec, relu,
                                st);
  return cudaGetLastError();
}
