// Fused dropout with a counter-based mask: one pass, no stored mask.
//
// Replaces the TPU kernel `pallas_dropout` in
// ode_vio_tpu/ops/pallas_kernels.py (`_dropout_kernel`, run by
// `_dropout_run`, forward and backward through its custom_vjp):
// y = x * [bits >= thresh] * scale with thresh = min(round(rate * 2^32),
// 2^32 - 1) and scale = 1 / (1 - rate). The TPU kernel draws its bits from
// the core's hardware PRNG seeded per tile; here they come from
// Philox4x32-10 (Salmon et al., SC'11; the Random123 constants), keyed by
// a 64-bit key and counted by the element index divided by 4, so one
// Philox call gives the bits of 4 consecutive elements and any element's
// bits depend only on (key, index). The backward pass is this same kernel
// on the incoming gradient with the same key: the mask is regenerated and
// never exists in memory in either direction.
//
// Kept elements are float(x) * scale rounded once to the element type
// (float, bfloat16 or half); dropped elements are 0. The plain PyTorch
// version in ode_vio_tpu_torch/ops/cuda_kernels.py computes the same
// Philox words in int64 arithmetic and must agree bit for bit.
//
// What bounds it on an H100: bytes. Each element is read once and written
// once (4 bytes per bf16 element in all, 8 per float); Philox costs 20
// 32-bit multiplies per 4 elements, far below the integer rate. Design: a
// grid-stride loop over groups of 4 elements, one Philox call and one
// vector load and store per group (8 bytes for 16-bit types, 16 for
// float), a scalar path for the last group of a size not divisible by 4
// and for pointers not aligned to a group.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr int kThreads = 256;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x), lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z), lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

template <typename T> struct Elem;
template <> struct Elem<float> {
  __device__ static float load(float v) { return v; }
  __device__ static float store(float v) { return v; }
};
template <> struct Elem<__nv_bfloat16> {
  __device__ static float load(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 store(float v) { return __float2bfloat16_rn(v); }
};
template <> struct Elem<__half> {
  __device__ static float load(__half v) { return __half2float(v); }
  __device__ static __half store(float v) { return __float2half_rn(v); }
};

// four elements, one aligned vector access
template <typename T> struct alignas(4 * sizeof(T)) Group { T v[4]; };

template <typename T>
__device__ __forceinline__ T drop(T x, uint32_t bits, uint32_t thresh, float scale) {
  return Elem<T>::store(bits >= thresh ? Elem<T>::load(x) * scale : 0.0f);
}

template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
fused_dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                     uint32_t k0, uint32_t k1, uint32_t thresh, float scale) {
  const long long groups = (n + 3) / 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < groups;
       g += stride) {
    const uint4 r = philox4x32_10(
        make_uint4((uint32_t)g, (uint32_t)((unsigned long long)g >> 32), 0u, 0u), k0, k1);
    const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
    const long long base = 4 * g;
    if (kVector && base + 4 <= n) {
      const Group<T> in = reinterpret_cast<const Group<T>*>(x)[g];
      Group<T> out;
#pragma unroll
      for (int j = 0; j < 4; ++j) out.v[j] = drop(in.v[j], bits[j], thresh, scale);
      reinterpret_cast<Group<T>*>(y)[g] = out;
    } else {
      for (int j = 0; j < 4 && base + j < n; ++j)
        y[base + j] = drop(x[base + j], bits[j], thresh, scale);
    }
  }
}

template <typename T>
int launch(const void* x, void* y, long long n, uint32_t k0, uint32_t k1,
           uint32_t thresh, float scale, cudaStream_t stream) {
  const long long groups = (n + 3) / 4;
  // enough blocks to fill the card several times over; the loop strides
  const long long want = (groups + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) %
                        sizeof(Group<T>)) == 0;
  if (aligned)
    fused_dropout_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), n, k0, k1, thresh, scale);
  else
    fused_dropout_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), n, k0, k1, thresh, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// y = dropout(x) over n contiguous elements on `stream`. dtype: 0 float,
// 1 bfloat16, 2 half. (k0, k1): the Philox key's low and high words.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fused_dropout_launch(const void* x, void* y, long long n, int dtype,
                                    uint32_t k0, uint32_t k1, uint32_t thresh,
                                    float scale, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, y, n, k0, k1, thresh, scale, s);
    case 1: return launch<__nv_bfloat16>(x, y, n, k0, k1, thresh, scale, s);
    case 2: return launch<__half>(x, y, n, k0, k1, thresh, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
