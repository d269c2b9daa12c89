// int8-weight matrix products for Hopper (sm_90a).
//
// Replaces two kernels of ganq_tpu/ops/w8_matmul.py:
//
// * w8_matmul (Pallas kernel _w8_kernel), entry ganq_w8_matmul:
//
//     out[b, m] = sum_k x[b, k] * rnd_x(float(w8[m, k]) * scale[m])
//
//   with rnd_x the rounding to x's type (the TPU kernel casts the
//   dequantized weight to x's type before its dot); sums in float, output
//   in x's type.
//
// * w8a8_matmul (Pallas kernel _w8a8_kernel), entry ganq_w8a8_matmul: per
//   token row sx = max(max|x| / 127, 1e-12), x8 = clamp(rint(x / sx), -127,
//   127) (IEEE division, ties to even, as jnp.round), an exact int32 dot
//   acc = x8 . w8[m], and out[b, m] = (float(acc) * sx[b]) * scale[m], in
//   that order.
//
// x arrives zero-padded to the weight's K' columns. Bound on this card at
// decode batch: the int8 weight bytes, M * K', over the memory rate (3.35
// TB/s on an H100 SXM); the work per weight is a convert and two flops
// (w8a8: a quarter of a dp4a). GEMV kernels: a warp owns kRows output rows
// and its lanes stride over 16-byte groups of a row (coalesced 512-byte
// rows per warp); a chunk of x (or x8) is staged in shared memory once per
// block and reused for every row. Token rows come in tiles of up to kMaxTB
// per block row; more rows run more block rows, each reading the weights
// again (from L2). A tensor-core path for many token rows is later work.

#include "a8_quant.cuh"

namespace {

constexpr int kWarps = 8;       // warps per block
constexpr int kRows = 2;        // output rows per warp
constexpr int kLaneCols = 16;   // weight columns per lane per chunk
constexpr int kChunk = 32 * kLaneCols;
constexpr int kMaxTB = 8;       // token rows per block row

// 16 int8 weights of each of a warp's rows from column k; rows past M repeat
// row M - 1, columns past Kp are 0
__device__ __forceinline__ void load_w8(const int8_t* __restrict__ w8, int m0,
                                        int M, int Kp, int k, bool vec,
                                        int (&wd)[kRows][4]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int8_t* row = w8 + (size_t)min(m0 + r, M - 1) * Kp + k;
    if (vec && k < Kp) {
      const int4 t = __ldg(reinterpret_cast<const int4*>(row));
      wd[r][0] = t.x; wd[r][1] = t.y; wd[r][2] = t.z; wd[r][3] = t.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int v = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (k + 4 * q + i < Kp)
            v |= ((int)(uint8_t)row[4 * q + i]) << (8 * i);
        wd[r][q] = v;
      }
    }
  }
}

__device__ __forceinline__ int byte_at(int word, int i) {
  return (int)(int8_t)(word >> (8 * i));
}

// ------------------------------------------------------------ kernel 7
template <typename XT, int TB>
__global__ void __launch_bounds__(kWarps * 32)
w8_gemv_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w8,
               const float* __restrict__ scale, XT* __restrict__ out, int B,
               int M, int Kp) {
  // this chunk's x as float4: entry (j * 4 + q) * 32 + lane holds columns
  // k0 + 16 * lane + 4 * q .. + 3 of token row j (lanes read neighbours)
  __shared__ float4 xs[TB * 4 * 32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = (blockIdx.x * kWarps + warp) * kRows;
  const int b0 = blockIdx.y * TB;
  const int nb = min(TB, B - b0);
  float s[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) s[r] = __ldg(scale + min(m0 + r, M - 1));

  float acc[kRows][TB];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < TB; ++j) acc[r][j] = 0.f;

  const bool vec = (Kp & 15) == 0;
  for (int k0 = 0; k0 < Kp; k0 += kChunk) {
    __syncthreads();   // previous chunk's x fully read
    for (int e = threadIdx.x; e < TB * 4 * 32; e += kWarps * 32) {
      const int ln = e % 32, q = (e / 32) % 4, j = e / 128;
      const int k = k0 + kLaneCols * ln + 4 * q;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (j < nb) {
        const XT* xp = x + (size_t)(b0 + j) * Kp + k;
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = k + i < Kp ? to_f(xp[i]) : 0.f;
      }
      xs[e] = make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
    const int k = k0 + kLaneCols * lane;
    if (m0 < M && k < Kp) {
      int wd[kRows][4];
      load_w8(w8, m0, M, Kp, k, vec, wd);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float4 xv[TB];
#pragma unroll
        for (int j = 0; j < TB; ++j) xv[j] = xs[(j * 4 + q) * 32 + lane];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float wv = rnd<XT>((float)byte_at(wd[r][q], i) * s[r]);
#pragma unroll
            for (int j = 0; j < TB; ++j) {
              const float xi = i == 0 ? xv[j].x : i == 1 ? xv[j].y
                             : i == 2 ? xv[j].z : xv[j].w;
              acc[r][j] = fmaf(xi, wv, acc[r][j]);
            }
          }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < TB; ++j) {
      float v = acc[r][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0 && j < nb && m0 + r < M)
        store(out + (size_t)(b0 + j) * M + m0 + r, v);
    }
}

template <typename XT, int TB>
void launch_w8(const void* x, const void* w8, const void* scale, void* out,
               int B, int M, int Kp, cudaStream_t stream) {
  const int rows_per_block = kWarps * kRows;
  const dim3 grid((M + rows_per_block - 1) / rows_per_block,
                  (B + TB - 1) / TB);
  w8_gemv_kernel<XT, TB><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const XT*>(x), static_cast<const int8_t*>(w8),
      static_cast<const float*>(scale), static_cast<XT*>(out), B, M, Kp);
}

template <typename XT>
void w8_tiles(const void* x, const void* w8, const void* scale, void* out,
              int B, int M, int Kp, cudaStream_t s) {
  if (B == 1) return launch_w8<XT, 1>(x, w8, scale, out, B, M, Kp, s);
  if (B == 2) return launch_w8<XT, 2>(x, w8, scale, out, B, M, Kp, s);
  if (B <= 4) return launch_w8<XT, 4>(x, w8, scale, out, B, M, Kp, s);
  launch_w8<XT, kMaxTB>(x, w8, scale, out, B, M, Kp, s);
}

// ------------------------------------------------------------ kernel 8
// (the activation quantization, quant_rows_kernel, is in a8_quant.cuh)

template <typename OT, int TB>
__global__ void __launch_bounds__(kWarps * 32)
w8a8_gemv_kernel(const int8_t* __restrict__ x8, const float* __restrict__ sx,
                 const int8_t* __restrict__ w8,
                 const float* __restrict__ scale, OT* __restrict__ out, int B,
                 int M, int Kp) {
  // this chunk's x8: entry j * 32 + lane holds columns k0 + 16 * lane ..
  // + 15 of token row j
  __shared__ int4 xs8[TB * 32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = (blockIdx.x * kWarps + warp) * kRows;
  const int b0 = blockIdx.y * TB;
  const int nb = min(TB, B - b0);

  int acc[kRows][TB];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < TB; ++j) acc[r][j] = 0;

  const bool vec = (Kp & 15) == 0;
  for (int k0 = 0; k0 < Kp; k0 += kChunk) {
    __syncthreads();   // previous chunk's x8 fully read
    for (int e = threadIdx.x; e < TB * 32; e += kWarps * 32) {
      const int ln = e % 32, j = e / 32;
      const int k = k0 + kLaneCols * ln;
      int4 v = make_int4(0, 0, 0, 0);
      if (j < nb && k < Kp) {
        const int8_t* xp = x8 + (size_t)(b0 + j) * Kp + k;
        if (vec) {
          v = __ldg(reinterpret_cast<const int4*>(xp));
        } else {
          int t[4] = {0, 0, 0, 0};
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (k + 4 * q + i < Kp)
                t[q] |= ((int)(uint8_t)xp[4 * q + i]) << (8 * i);
          v = make_int4(t[0], t[1], t[2], t[3]);
        }
      }
      xs8[e] = v;
    }
    __syncthreads();
    const int k = k0 + kLaneCols * lane;
    if (m0 < M && k < Kp) {
      int wd[kRows][4];
      load_w8(w8, m0, M, Kp, k, vec, wd);
#pragma unroll
      for (int j = 0; j < TB; ++j) {
        const int4 xv = xs8[j * 32 + lane];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          int a = acc[r][j];
          a = __dp4a(xv.x, wd[r][0], a);
          a = __dp4a(xv.y, wd[r][1], a);
          a = __dp4a(xv.z, wd[r][2], a);
          a = __dp4a(xv.w, wd[r][3], a);
          acc[r][j] = a;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float s = __ldg(scale + min(m0 + r, M - 1));
#pragma unroll
    for (int j = 0; j < TB; ++j) {
      const int a = __reduce_add_sync(0xffffffffu, acc[r][j]);
      if (lane == 0 && j < nb && m0 + r < M)
        store(out + (size_t)(b0 + j) * M + m0 + r,
              ((float)a * sx[b0 + j]) * s);
    }
  }
}

template <typename OT, int TB>
void launch_w8a8(const void* x8, const void* sx, const void* w8,
                 const void* scale, void* out, int B, int M, int Kp,
                 cudaStream_t stream) {
  const int rows_per_block = kWarps * kRows;
  const dim3 grid((M + rows_per_block - 1) / rows_per_block,
                  (B + TB - 1) / TB);
  w8a8_gemv_kernel<OT, TB><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const int8_t*>(x8), static_cast<const float*>(sx),
      static_cast<const int8_t*>(w8), static_cast<const float*>(scale),
      static_cast<OT*>(out), B, M, Kp);
}

template <typename OT>
void w8a8_tiles(const void* x8, const void* sx, const void* w8,
                const void* scale, void* out, int B, int M, int Kp,
                cudaStream_t s) {
  if (B == 1) return launch_w8a8<OT, 1>(x8, sx, w8, scale, out, B, M, Kp, s);
  if (B == 2) return launch_w8a8<OT, 2>(x8, sx, w8, scale, out, B, M, Kp, s);
  if (B <= 4) return launch_w8a8<OT, 4>(x8, sx, w8, scale, out, B, M, Kp, s);
  launch_w8a8<OT, kMaxTB>(x8, sx, w8, scale, out, B, M, Kp, s);
}

}  // namespace

// x [B, Kp] (bf16 if x_bf16 else f32), w8 [M, Kp] int8, scale [M] f32, out
// [B, M] in x's type; all contiguous, x and w8 16-byte aligned. Returns the
// cudaError_t of the launch.
extern "C" int ganq_w8_matmul(const void* x, const void* w8, const void* scale,
                              void* out, int B, int M, int Kp, int x_bf16,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    w8_tiles<bf16>(x, w8, scale, out, B, M, Kp, s);
  else
    w8_tiles<float>(x, w8, scale, out, B, M, Kp, s);
  return (int)cudaGetLastError();
}

// x [B, Kp] (bf16 if x_bf16 else f32); scratch x8 [B, Kp] int8 and sx [B]
// f32; w8 [M, Kp] int8, scale [M] f32, out [B, M] in x's type. Two
// launches (activation quantization, then the int8 GEMV) on the stream.
extern "C" int ganq_w8a8_matmul(const void* x, const void* w8,
                                const void* scale, void* x8, void* sx,
                                void* out, int B, int M, int Kp, int x_bf16,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      launch_quant(x, x_bf16, B, Kp, x8, sx, nullptr, 0, 1, s);
  if (err != cudaSuccess) return (int)err;
  if (x_bf16)
    w8a8_tiles<bf16>(x8, sx, w8, scale, out, B, M, Kp, s);
  else
    w8a8_tiles<float>(x8, sx, w8, scale, out, B, M, Kp, s);
  return (int)cudaGetLastError();
}
