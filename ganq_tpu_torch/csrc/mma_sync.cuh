// Helpers shared by the tensor-core paths of lut_matmul.cu (kernel 1),
// flash_decode.cu (kernel 2), uniform_matmul.cu (kernels 5-6) and
// w8_matmul.cu (kernels 7-8): mma.sync and ldmatrix wrappers,
// cp.async, the opt-in to more than 48 KB of dynamic shared memory, and the
// second launch that adds the float32 partial sums of a K split in split
// order.
//
// Internal linkage, as a8_quant.cuh (which this includes): each source
// includes it into its own shared library.

#pragma once

#include "a8_quant.cuh"

namespace {

// dynamic shared memory above 48 KB has to be allowed once per kernel
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, bool& raised) {
  if (smem > 48 * 1024 && !raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  return cudaSuccess;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices from shared memory; lane L gives row L & 7 of
// matrix L >> 3
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// the same, each matrix transposed: lane L gets column L >> 2 of rows 2 (L
// & 3) and 2 (L & 3) + 1
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 16 bytes global -> shared; zero-filled (nothing read) when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a),
               "l"(src), "r"(ok ? 16 : 0));
}
// 8 bytes global -> shared (through L1); zero-filled when !ok
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool ok) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(a),
               "l"(src), "r"(ok ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// two weights rounded to bf16 in one register, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void store_out(void* out, int out_bf16, size_t o,
                                          float v) {
  if (out_bf16)
    store(static_cast<bf16*>(out) + o, v);
  else
    store(static_cast<float*>(out) + o, v);
}

// the splits' partial sums [nsplit][B][M] added in split order (times sx
// for kernel 6) into the output
__global__ void __launch_bounds__(256)
sum_splits_kernel(const float* __restrict__ part, int nsplit, int B, int M,
                  const float* __restrict__ sx, void* __restrict__ out,
                  int out_bf16) {
  const size_t n = (size_t)B * M;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int s = 1; s < nsplit; ++s) v += part[(size_t)s * n + i];
    if (sx) v *= __ldg(sx + i / M);
    store_out(out, out_bf16, i, v);
  }
}

inline cudaError_t launch_sum_splits(const float* part, int nsplit, int B,
                                     int M, const float* sx, void* out,
                                     int out_bf16, cudaStream_t s) {
  const size_t n = (size_t)B * M;
  const int blocks = (int)min((n + 255) / 256, (size_t)4096);
  sum_splits_kernel<<<blocks, 256, 0, s>>>(part, nsplit, B, M, sx, out,
                                           out_bf16);
  return cudaGetLastError();
}

}  // namespace
