// Mixture-of-experts dispatch and combine for Hopper (sm_90a), hand-written
// CUDA C++.
//
// Replaces the TPU kernels `_dispatch_kernel` and `_combine_kernel` of
// mxnet_tpu/pallas_ops/moe_kernels.py, launched by `dispatch_to_experts`
// and `combine_from_experts` (cuda_ops/moe_kernels.py) inside `moe_ffn`,
// forward and, through each other, backward:
//   dispatch: buf[e, c] = sum_n [expert_n = e][pos_n = c] x[n]
//   combine : y[n]      = gate_n * buf[expert_n, pos_n]
// A token whose expert lies outside [0, E) or whose pos lies outside
// [0, C) is dropped: it dispatches nowhere and combines to zeros.
//
// The TPU kernels build a one-hot (C, block_n) selection tile in VMEM and
// spend O(N E C D) matrix-unit work on what is a permutation of rows. Here
// dispatch is a row scatter and combine a row gather: no products at all.
// What bounds both: bytes. Dispatch reads the N kept rows of x and writes
// the E C D floats of buf once; combine reads N rows of buf and writes the
// N D floats of y. Rows move as 16-byte vectors when D % 4 == 0 and the
// pointers are 16-byte aligned (the wrapper checks), else as floats; one
// warp owns a row, so neighbouring lanes touch neighbouring addresses.
// Offsets are 64-bit.
//
// Dispatch runs four launches on the caller's stream:
//   1. moe_clear_kernel: zero a per-slot count and owner (2 E C int32 of
//      scratch the wrapper allocates);
//   2. moe_route_kernel: one thread per kept token: count[slot] += 1 and
//      owner[slot] = max(owner[slot], n), integer atomics (exact);
//   3. moe_gather_kernel: one warp per slot: a slot of count 1 copies its
//      owner's row, any other slot is written zeros. Every element of buf
//      is written once, by a plain store, so on `moe_route`'s routing
//      (each slot at most one token) buf equals the plain version bit for
//      bit, subnormals included;
//   4. moe_dup_kernel: one warp per token whose slot holds more than one
//      token adds its row into the zeroed slot with float atomics. Only
//      routing with duplicates (which `moe_route` never produces) reaches
//      it; their sum is taken in an order that may change from run to run,
//      and float atomics flush subnormals (PTX `red.add.f32`), both well
//      within the plain version's 1e-6.
// Combine is one launch: a warp per token multiplies its slot's row by the
// gate with an explicit round-to-nearest product (what the plain one-hot
// product gives, bit for bit) or writes zeros for a dropped token.
#include "common.cuh"

namespace mxt {
namespace {

constexpr int WARPS = 8;              // rows per block: one warp each

__device__ __forceinline__ bool kept(int e, int p, int E, int C) {
  return e >= 0 && e < E && p >= 0 && p < C;
}

__global__ void moe_clear_kernel(int* __restrict__ scratch, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    scratch[i] = 0;
}

__global__ void moe_route_kernel(const int* __restrict__ expert,
                                 const int* __restrict__ pos,
                                 int* __restrict__ count,
                                 int* __restrict__ owner, long long N, int E,
                                 int C) {
  const long long n = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int e = expert[n], p = pos[n];
  if (!kept(e, p, E, C)) return;
  const long long s = (long long)e * C + p;
  atomicAdd(count + s, 1);
  atomicMax(owner + s, (int)n);
}

template <bool V4>
__global__ void __launch_bounds__(WARPS * 32)
moe_gather_kernel(const float* __restrict__ x, const int* __restrict__ count,
                  const int* __restrict__ owner, float* __restrict__ buf,
                  long long slots, int D) {
  const long long s = blockIdx.x * (long long)WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (s >= slots) return;
  float* dst = buf + s * D;
  const bool copy = count[s] == 1;
  const float* src = copy ? x + (long long)owner[s] * D : nullptr;
  if (V4) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int i = lane; i < D / 4; i += 32)
      d4[i] = copy ? s4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int i = lane; i < D; i += 32) dst[i] = copy ? src[i] : 0.f;
  }
}

__global__ void __launch_bounds__(WARPS * 32)
moe_dup_kernel(const float* __restrict__ x, const int* __restrict__ expert,
               const int* __restrict__ pos, const int* __restrict__ count,
               float* __restrict__ buf, long long N, int D, int E, int C) {
  const long long n = blockIdx.x * (long long)WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (n >= N) return;
  const int e = expert[n], p = pos[n];
  if (!kept(e, p, E, C)) return;
  const long long s = (long long)e * C + p;
  if (count[s] <= 1) return;
  float* dst = buf + s * D;
  const float* src = x + n * D;
  for (int i = lane; i < D; i += 32) atomicAdd(dst + i, src[i]);
}

template <bool V4>
__global__ void __launch_bounds__(WARPS * 32)
moe_combine_kernel(const float* __restrict__ buf,
                   const int* __restrict__ expert,
                   const int* __restrict__ pos,
                   const float* __restrict__ gate, float* __restrict__ y,
                   long long N, int D, int E, int C) {
  const long long n = blockIdx.x * (long long)WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (n >= N) return;
  const int e = expert[n], p = pos[n];
  const bool keep = kept(e, p, E, C);
  const float g = gate[n];
  const float* src = keep ? buf + ((long long)e * C + p) * D : nullptr;
  float* dst = y + n * D;
  if (V4) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int i = lane; i < D / 4; i += 32) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (keep) {
        const float4 b = s4[i];
        v = make_float4(__fmul_rn(g, b.x), __fmul_rn(g, b.y),
                        __fmul_rn(g, b.z), __fmul_rn(g, b.w));
      }
      d4[i] = v;
    }
  } else {
    for (int i = lane; i < D; i += 32)
      dst[i] = keep ? __fmul_rn(g, src[i]) : 0.f;
  }
}

unsigned warp_blocks(long long rows) {
  return (unsigned)((rows + WARPS - 1) / WARPS);
}

}  // namespace
}  // namespace mxt

// x (N, D) float32, expert and pos (N,) int32, buf (E, C, D) float32 (its
// contents are overwritten), scratch 2 E C int32; all contiguous on one
// device; vec4: D % 4 == 0 and x, buf 16-byte aligned. Returns the CUDA
// error of the launches.
extern "C" int mx_moe_dispatch(const void* x, const void* expert,
                               const void* pos, void* buf, void* scratch,
                               long long N, int D, int E, int C, int vec4,
                               void* stream) {
  using namespace mxt;
  if (N < 0 || N > 0x7fffffffLL || D <= 0 || E <= 0 || C <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long slots = (long long)E * C;
  int* count = static_cast<int*>(scratch);
  int* owner = count + slots;
  const float* xf = static_cast<const float*>(x);
  const int* ex = static_cast<const int*>(expert);
  const int* ps = static_cast<const int*>(pos);
  float* bf = static_cast<float*>(buf);
  const long long clear_blocks = (2 * slots + 255) / 256;
  moe_clear_kernel<<<(unsigned)(clear_blocks < 4096 ? clear_blocks : 4096),
                     256, 0, st>>>(count, 2 * slots);
  if (N > 0)
    moe_route_kernel<<<(unsigned)((N + 255) / 256), 256, 0, st>>>(
        ex, ps, count, owner, N, E, C);
  if (vec4)
    moe_gather_kernel<true><<<warp_blocks(slots), WARPS * 32, 0, st>>>(
        xf, count, owner, bf, slots, D);
  else
    moe_gather_kernel<false><<<warp_blocks(slots), WARPS * 32, 0, st>>>(
        xf, count, owner, bf, slots, D);
  if (N > 0)
    moe_dup_kernel<<<warp_blocks(N), WARPS * 32, 0, st>>>(xf, ex, ps, count,
                                                          bf, N, D, E, C);
  return cudaGetLastError();
}

// buf (E, C, D) float32, expert and pos (N,) int32, gate (N,) float32,
// y (N, D) float32; all contiguous on one device; N > 0; vec4: D % 4 == 0
// and buf, y 16-byte aligned. Returns the CUDA error of the launch.
extern "C" int mx_moe_combine(const void* buf, const void* expert,
                              const void* pos, const void* gate, void* y,
                              long long N, int D, int E, int C, int vec4,
                              void* stream) {
  using namespace mxt;
  if (N <= 0 || D <= 0 || E <= 0 || C <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(buf);
  const int* ex = static_cast<const int*>(expert);
  const int* ps = static_cast<const int*>(pos);
  const float* g = static_cast<const float*>(gate);
  float* yf = static_cast<float*>(y);
  if (vec4)
    moe_combine_kernel<true><<<warp_blocks(N), WARPS * 32, 0, st>>>(
        bf, ex, ps, g, yf, N, D, E, C);
  else
    moe_combine_kernel<false><<<warp_blocks(N), WARPS * 32, 0, st>>>(
        bf, ex, ps, g, yf, N, D, E, C);
  return cudaGetLastError();
}
