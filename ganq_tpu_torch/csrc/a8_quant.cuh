// Per-token int8 activation quantization: the one rule every int8-activation
// kernel of the port follows (kernel 6 in uniform_matmul.cu, kernel 8 in
// w8_matmul.cu, the phases of kernels 9-15 through w8a8_fused.cuh), and the
// element helpers those sources use.
//
// The JAX package writes sx = max(max|x| / 127.0, 1e-12) and runs it jitted
// or inside a kernel, where XLA compiles the division by a constant into a
// product with fl(1/127): sx_of forms that product (it differs from the IEEE
// quotient in the last bit on some rows). The attention outputs' scale,
// max(max|a|, 1e-12) / 127.0 in the JAX kernels, is the same product taken
// after the clamp (sa_of). The codes are x8 = clamp(rint(x / sx), -127, 127):
// jnp.round(x / sx) divides by a traced value, so that stays an IEEE
// quotient with ties to even (quant8). A product with 1 / sx, or roundf,
// flips codes at rounding ties.
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

// element i of a 16-byte load of x as a float
template <typename XT>
__device__ __forceinline__ float x_at(const uint4& u, int i);
template <>
__device__ __forceinline__ float x_at<float>(const uint4& u, int i) {
  return __uint_as_float(i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w);
}
template <>
__device__ __forceinline__ float x_at<bf16>(const uint4& u, int i) {
  const uint32_t w = (i >> 1) == 0 ? u.x : (i >> 1) == 1 ? u.y
                   : (i >> 1) == 2 ? u.z : u.w;
  return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}

constexpr float kInv127 = 1.f / 127.f;   // fl(1/127), folded at compile time

// a token row's scale from its max|x|: max(max|x| * fl(1/127), 1e-12)
__device__ __forceinline__ float sx_of(float amax) {
  return fmaxf(amax * kInv127, 1e-12f);
}
// the attention output's scale from max(max|a|, 1e-12): times fl(1/127)
__device__ __forceinline__ float sa_of(float m) { return m * kInv127; }

__device__ __forceinline__ int quant8(float v, float s) {
  const float q = rintf(v / s);                // IEEE division, ties to even
  return (int)fminf(fmaxf(q, -127.f), 127.f);
}

constexpr int kQuantThreads = 256;
// a row of at most kQuantVecs 16-byte loads a thread stays in registers
constexpr int kQuantVecs = 8;

// A block per token row: sx, the int8 row and (when sumx is given) the sums
// of x8 over each of the G sequential groups of gs columns. Where K' is a
// multiple of 16 and the row fits, the row stays in registers and x is read
// once (the group sums read it again); otherwise twice, an element at a
// time. It lets a dependent launch start at once (kernel 8's decode kernel,
// launched with programmatic stream serialization, copies its first
// weights meanwhile).
template <typename XT>
__global__ void __launch_bounds__(kQuantThreads)
quant_rows_a8_kernel(const XT* __restrict__ x, int Kp,
                     int8_t* __restrict__ x8, float* __restrict__ sx,
                     int32_t* __restrict__ sumx, int G, int gs) {
  constexpr int V = 16 / (int)sizeof(XT);
  __shared__ float red[kQuantThreads / 32];
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int b = blockIdx.x;
  const XT* xr = x + (size_t)b * Kp;
  const int nv = Kp / V;
  const bool vec = Kp % 16 == 0 && nv <= kQuantVecs * kQuantThreads;
  uint4 u[kQuantVecs];
  float amax = 0.f;
  if (vec) {
#pragma unroll
    for (int i = 0; i < kQuantVecs; ++i) {
      const int v = threadIdx.x + i * kQuantThreads;
      u[i] = v < nv ? __ldg(reinterpret_cast<const uint4*>(xr) + v)
                    : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int e = 0; e < V; ++e)
        amax = fmaxf(amax, fabsf(x_at<XT>(u[i], e)));
    }
  } else {
    for (int k = threadIdx.x; k < Kp; k += kQuantThreads)
      amax = fmaxf(amax, fabsf(to_f(xr[k])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < kQuantThreads / 32; ++w) amax = fmaxf(amax, red[w]);
  const float s = sx_of(amax);
  int8_t* dr = x8 + (size_t)b * Kp;
  if (vec) {
#pragma unroll
    for (int i = 0; i < kQuantVecs; ++i) {
      const int v = threadIdx.x + i * kQuantThreads;
      if (v >= nv) break;
      uint32_t q[V / 4];
#pragma unroll
      for (int k = 0; k < V / 4; ++k) q[k] = 0u;
#pragma unroll
      for (int e = 0; e < V; ++e)
        q[e / 4] |= (uint32_t)(quant8(x_at<XT>(u[i], e), s) & 0xff)
                    << (8 * (e % 4));
      if constexpr (V == 8)
        *reinterpret_cast<uint2*>(dr + (size_t)v * V) = make_uint2(q[0], q[1]);
      else
        *reinterpret_cast<uint32_t*>(dr + (size_t)v * V) = q[0];
    }
  } else {
    for (int k = threadIdx.x; k < Kp; k += kQuantThreads)
      dr[k] = (int8_t)quant8(to_f(xr[k]), s);
  }
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

// x [B, Kp] (bf16 if x_bf16 else f32, 16-byte aligned) -> x8 [B, Kp] int8,
// sx [B] f32 and, when sumx is not null, sumx [B, G] int32 over groups of
// gs columns
inline cudaError_t quant_a8(const void* x, int x_bf16, int B, int Kp,
                            void* x8, void* sx, void* sumx, int G, int gs,
                            cudaStream_t stream) {
  int8_t* q = static_cast<int8_t*>(x8);
  float* s = static_cast<float*>(sx);
  int32_t* sums = static_cast<int32_t*>(sumx);
  if (x_bf16)
    quant_rows_a8_kernel<bf16><<<B, kQuantThreads, 0, stream>>>(
        static_cast<const bf16*>(x), Kp, q, s, sums, G, gs);
  else
    quant_rows_a8_kernel<float><<<B, kQuantThreads, 0, stream>>>(
        static_cast<const float*>(x), Kp, q, s, sums, G, gs);
  return cudaGetLastError();
}

}  // namespace
