// Per-token int8 activation quantization shared by the int8-activation
// kernels (uniform_matmul.cu kernel 6, w8_matmul.cu kernel 8), and the
// element helpers both sources use.
//
// The rounding rule is the JAX package's jnp.round(x / sx): per token row
// sx = max(max|x| / 127, 1e-12), x8 = clamp(rint(x / sx), -127, 127) with an
// IEEE division and ties to even. A product with 1/sx, or roundf, flips
// codes; keep one copy of the rule, here.
//
// Internal linkage: each source includes this into its own shared library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}
// v rounded to T and widened back
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<bf16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

constexpr int kQuantThreads = 256;

__device__ __forceinline__ int quant8(float v, float s) {
  const float q = rintf(v / s);                // IEEE division, ties to even
  return (int)fminf(fmaxf(q, -127.f), 127.f);
}

// one block per token row: sx, the int8 row and (when sumx is given) the
// sums of x8 over each of the G sequential groups of gs columns
template <typename XT>
__global__ void __launch_bounds__(kQuantThreads)
quant_rows_kernel(const XT* __restrict__ x, int K, int8_t* __restrict__ x8,
                  float* __restrict__ sx, int32_t* __restrict__ sumx, int G,
                  int gs) {
  __shared__ float red[kQuantThreads / 32];
  const int b = blockIdx.x;
  const XT* xr = x + (size_t)b * K;
  float amax = 0.f;
  for (int k = threadIdx.x; k < K; k += kQuantThreads)
    amax = fmaxf(amax, fabsf(to_f(xr[k])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < kQuantThreads / 32; ++w) amax = fmaxf(amax, red[w]);
  const float s = fmaxf(amax / 127.f, 1e-12f);
  for (int k = threadIdx.x; k < K; k += kQuantThreads)
    x8[(size_t)b * K + k] = (int8_t)quant8(to_f(xr[k]), s);
  if (sumx) {
    for (int g = warp; g < G; g += kQuantThreads / 32) {
      int t = 0;
      for (int k = g * gs + lane; k < (g + 1) * gs; k += 32)
        t += quant8(to_f(xr[k]), s);
      t = __reduce_add_sync(0xffffffffu, t);
      if (lane == 0) sumx[(size_t)b * G + g] = t;
    }
  }
  if (threadIdx.x == 0) sx[b] = s;
}

// x [B, K] (bf16 if x_bf16 else f32) -> x8 [B, K] int8, sx [B] f32 and,
// when sumx is not null, sumx [B, G] int32 over groups of gs columns
inline cudaError_t launch_quant(const void* x, int x_bf16, int B, int K,
                                void* x8, void* sx, void* sumx, int G, int gs,
                                cudaStream_t stream) {
  if (x_bf16)
    quant_rows_kernel<bf16><<<B, kQuantThreads, 0, stream>>>(
        static_cast<const bf16*>(x), K, static_cast<int8_t*>(x8),
        static_cast<float*>(sx), static_cast<int32_t*>(sumx), G, gs);
  else
    quant_rows_kernel<float><<<B, kQuantThreads, 0, stream>>>(
        static_cast<const float*>(x), K, static_cast<int8_t*>(x8),
        static_cast<float*>(sx), static_cast<int32_t*>(sumx), G, gs);
  return cudaGetLastError();
}

}  // namespace
