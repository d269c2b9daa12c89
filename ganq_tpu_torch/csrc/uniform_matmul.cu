// Uniform (scale / zero-point) dequant matrix products for Hopper (sm_90a).
//
// Replaces two kernels of ganq_tpu/ops/uniform_matmul.py:
//
// * uniform_matmul (Pallas kernel _uniform_kernel), entry
//   ganq_uniform_matmul:
//
//     out[b, m] = sum_k x[b, k] * w[m, k],
//     w[m, k]   = rnd_x((float(q[m, k]) - z[m, g(k)]) * s[m, g(k)])
//
//   with rnd_x the rounding to x's type (the TPU kernel casts the
//   dequantized weight to x's type before its dot), g(k) = g_idx[k] when the
//   artifact has a column -> group map and k / gs otherwise, and z the
//   symmetric centre 2^(bits-1) when the artifact stores no zeros. Any
//   shape, any g_idx (the TPU kernel sends permuted g_idx to XLA). Sums in
//   float, output in x's type.
//
// * uniform_a8_matmul (Pallas kernel _uniform_a8_kernel), entry
//   ganq_uniform_a8_matmul: per token row sx = max(max|x| / 127, 1e-12),
//   x8 = clamp(rint(x / sx), -127, 127) (IEEE division, ties to even, as
//   jnp.round), then per group an exact int32 dot of x8 with the codes
//   (8-bit codes centred by 128 to fit int8, the offset folded into the
//   zero side: z' = z - 128), and
//
//     out[b, m] = sx[b] * (sum_g s_g * dot_g - sum_g s_g z'_g * sum(x8)_g),
//
//   s_g z'_g formed in float32 as s_g * (z_g - zoff), as the JAX wrapper
//   forms it.
//
//   Sequential groups whose 128-column spans of a plane lie inside one group
//   (the wrapper's copy of the TPU gate guarantees it).
//
// Codes are planar-packed in int32 words (ops/packing.py): bit-slot p of
// word w of row m holds the code of column p * width + w; 3-bit codes take
// a nibble. Bound on this card at decode batch: the packed weight bytes,
// M * K * bits / 8, plus scales, over the memory rate (3.35 TB/s on an H100
// SXM); the work per weight is a shift, a mask and two flops (a8: a quarter
// of a dp4a). Both are GEMV kernels in the structure of csrc/lut_matmul.cu:
// a warp owns kRows output rows, its lanes stride over 16-byte groups of
// packed words (coalesced 512-byte rows per warp), and a chunk of x (or x8)
// is staged in shared memory once per block and reused for every row and
// plane. Token rows come in tiles of up to kMaxTB per block row; more rows
// run more block rows, each reading the weights again (from L2). A
// tensor-core path for many token rows is later work.

#include "a8_quant.cuh"

namespace {

template <int BITS> struct Codes {
  static constexpr int kSlot = BITS == 3 ? 4 : BITS;   // bits per slot
  static constexpr int kPf = 32 / kSlot;               // codes per word
  static constexpr uint32_t kMask = (1u << BITS) - 1u;
  static __device__ __forceinline__ int at(uint32_t word, int p) {
    return (word >> (kSlot * p)) & kMask;
  }
};

constexpr int kWarps = 8;       // warps per block
constexpr int kRows = 2;        // output rows per warp
constexpr int kChunkQ = 32;     // 4-word groups per row per chunk (a lane each)
constexpr int kChunkWords = 4 * kChunkQ;
constexpr int kMaxTB = 8;       // token rows per block row

__device__ __forceinline__ float part(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// one 4-word group of packed codes of each of a warp's rows; rows past M
// repeat row M - 1 (their sums are never stored), words past width are 0
__device__ __forceinline__ void load_words(const int32_t* __restrict__ qw,
                                           int m0, int M, int width, int w,
                                           bool vec, uint32_t (&wd)[kRows][4]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int32_t* row = qw + (size_t)min(m0 + r, M - 1) * width + w;
    if (vec && w < width) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(row));
      wd[r][0] = t.x; wd[r][1] = t.y; wd[r][2] = t.z; wd[r][3] = t.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wd[r][i] = w + i < width ? (uint32_t)__ldg(row + i) : 0u;
    }
  }
}

// ------------------------------------------------------------ kernel 5
template <typename XT, int BITS, int TB>
__global__ void __launch_bounds__(kWarps * 32)
uniform_gemv_kernel(const XT* __restrict__ x, const int32_t* __restrict__ qw,
                    const float* __restrict__ scales,
                    const float* __restrict__ zeros,
                    const int32_t* __restrict__ gidx, XT* __restrict__ out,
                    int B, int M, int width, int G, int gs, float center) {
  using C = Codes<BITS>;
  // this chunk's x as float: entry (j * kPf + p) * kChunkQ + lane holds
  // columns p * width + w0 + 4 * lane .. + 3 of token row j
  extern __shared__ float4 xs[];
  __shared__ int grp[C::kPf][kChunkWords];   // group of each chunk column
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = (blockIdx.x * kWarps + warp) * kRows;
  const int b0 = blockIdx.y * TB;
  const int nb = min(TB, B - b0);
  const size_t K = (size_t)width * C::kPf;

  float acc[kRows][TB];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < TB; ++j) acc[r][j] = 0.f;

  const bool vec = (width & 3) == 0;   // rows and x planes 16-byte aligned
  const int nchunk = (width + kChunkWords - 1) / kChunkWords;
  for (int c = 0; c < nchunk; ++c) {
    const int w0 = c * kChunkWords;
    __syncthreads();   // previous chunk's x and groups fully read
    for (int e = threadIdx.x; e < TB * C::kPf * kChunkQ; e += kWarps * 32) {
      const int g = e % kChunkQ, jp = e / kChunkQ;
      const int p = jp % C::kPf, j = jp / C::kPf;
      const int w = w0 + 4 * g;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (j < nb && w < width) {
        const XT* xp = x + (size_t)(b0 + j) * K + (size_t)p * width + w;
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = w + i < width ? to_f(xp[i]) : 0.f;
      }
      xs[e] = make_float4(v[0], v[1], v[2], v[3]);
    }
    for (int e = threadIdx.x; e < C::kPf * kChunkWords; e += kWarps * 32) {
      const int p = e / kChunkWords, i = e % kChunkWords;
      const int w = w0 + i;
      const int col = p * width + w;
      grp[p][i] = w < width ? (gidx ? __ldg(gidx + col) : col / gs) : 0;
    }
    __syncthreads();
    if (m0 < M && w0 + 4 * lane < width) {
      uint32_t wd[kRows][4];
      load_words(qw, m0, M, width, w0 + 4 * lane, vec, wd);
#pragma unroll
      for (int p = 0; p < C::kPf; ++p) {
        float4 xv[TB];
#pragma unroll
        for (int j = 0; j < TB; ++j) xv[j] = xs[(j * C::kPf + p) * kChunkQ + lane];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const size_t row = (size_t)min(m0 + r, M - 1) * G;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int g = grp[p][4 * lane + i];
            const float s = __ldg(scales + row + g);
            const float z = zeros ? __ldg(zeros + row + g) : center;
            const float wv =
                rnd<XT>(((float)C::at(wd[r][i], p) - z) * s);
#pragma unroll
            for (int j = 0; j < TB; ++j)
              acc[r][j] = fmaf(part(xv[j], i), wv, acc[r][j]);
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

template <typename XT, int BITS, int TB>
cudaError_t launch_uniform(const void* x, const void* qw, const void* scales,
                           const void* zeros, const void* gidx, void* out,
                           int B, int M, int width, int G, int gs,
                           cudaStream_t stream) {
  const auto kernel = uniform_gemv_kernel<XT, BITS, TB>;
  const size_t smem = sizeof(float4) * TB * Codes<BITS>::kPf * kChunkQ;
  static bool raised = false;
  const cudaError_t err = allow_smem(kernel, smem, raised);
  if (err != cudaSuccess) return err;
  const int rows_per_block = kWarps * kRows;
  const dim3 grid((M + rows_per_block - 1) / rows_per_block,
                  (B + TB - 1) / TB);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const int32_t*>(qw),
      static_cast<const float*>(scales), static_cast<const float*>(zeros),
      static_cast<const int32_t*>(gidx), static_cast<XT*>(out), B, M, width,
      G, gs, (float)(1 << (BITS - 1)));
  return cudaSuccess;
}

template <typename XT, int BITS>
cudaError_t uniform_tiles(const void* x, const void* qw, const void* scales,
                          const void* zeros, const void* gidx, void* out,
                          int B, int M, int width, int G, int gs,
                          cudaStream_t s) {
  if (B == 1)
    return launch_uniform<XT, BITS, 1>(x, qw, scales, zeros, gidx, out, B, M,
                                       width, G, gs, s);
  if (B == 2)
    return launch_uniform<XT, BITS, 2>(x, qw, scales, zeros, gidx, out, B, M,
                                       width, G, gs, s);
  if (B <= 4)
    return launch_uniform<XT, BITS, 4>(x, qw, scales, zeros, gidx, out, B, M,
                                       width, G, gs, s);
  return launch_uniform<XT, BITS, kMaxTB>(x, qw, scales, zeros, gidx, out, B,
                                          M, width, G, gs, s);
}

template <typename XT>
cudaError_t uniform_bits(const void* x, const void* qw, const void* scales,
                         const void* zeros, const void* gidx, void* out, int B,
                         int M, int width, int G, int gs, int bits,
                         cudaStream_t s) {
  switch (bits) {
    case 2: return uniform_tiles<XT, 2>(x, qw, scales, zeros, gidx, out, B, M, width, G, gs, s);
    case 3: return uniform_tiles<XT, 3>(x, qw, scales, zeros, gidx, out, B, M, width, G, gs, s);
    case 4: return uniform_tiles<XT, 4>(x, qw, scales, zeros, gidx, out, B, M, width, G, gs, s);
    case 8: return uniform_tiles<XT, 8>(x, qw, scales, zeros, gidx, out, B, M, width, G, gs, s);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------ kernel 6
// (the activation quantization, quant_rows_kernel, is in a8_quant.cuh)

// four int8 values, as one int32 for __dp4a
__device__ __forceinline__ int pack4(int a, int b, int c, int d) {
  return (a & 0xff) | ((b & 0xff) << 8) | ((c & 0xff) << 16) |
         ((int)((unsigned)d << 24));
}

template <typename OT, int BITS, int TB>
__global__ void __launch_bounds__(kWarps * 32)
uniform_a8_gemv_kernel(const int8_t* __restrict__ x8,
                       const float* __restrict__ sx,
                       const int32_t* __restrict__ sumx,
                       const int32_t* __restrict__ qw,
                       const float* __restrict__ scales,
                       const float* __restrict__ zeros, OT* __restrict__ out,
                       int B, int M, int width, int G, int gs) {
  using C = Codes<BITS>;
  constexpr int kCentre = BITS == 8 ? 128 : 0;   // codes as int8
  constexpr float kSym = (float)(1 << (BITS - 1));
  // this chunk's x8: entry (j * kPf + p) * kChunkQ + lane packs columns
  // p * width + w0 + 4 * lane .. + 3 of token row j
  extern __shared__ int xs8[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = (blockIdx.x * kWarps + warp) * kRows;
  const int b0 = blockIdx.y * TB;
  const int nb = min(TB, B - b0);
  const size_t K = (size_t)width * C::kPf;

  // zero-point side first: acc = -sum_g sumx_g * s_g z'_g
  float acc[kRows][TB];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const size_t row = (size_t)min(m0 + r, M - 1) * G;
#pragma unroll
    for (int j = 0; j < TB; ++j) {
      float t = 0.f;
      if (j < nb)
        for (int g = lane; g < G; g += 32)
          t = fmaf((float)__ldg(sumx + (size_t)(b0 + j) * G + g),
                   __ldg(scales + row + g) *
                       ((zeros ? __ldg(zeros + row + g) : kSym) - kCentre),
                   t);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        t += __shfl_xor_sync(0xffffffffu, t, off);
      acc[r][j] = -t;
    }
  }

  const bool vec = (width & 3) == 0;
  const int nchunk = (width + kChunkWords - 1) / kChunkWords;
  for (int c = 0; c < nchunk; ++c) {
    const int w0 = c * kChunkWords;
    __syncthreads();   // previous chunk's x8 fully read
    for (int e = threadIdx.x; e < TB * C::kPf * kChunkQ; e += kWarps * 32) {
      const int g = e % kChunkQ, jp = e / kChunkQ;
      const int p = jp % C::kPf, j = jp / C::kPf;
      const int w = w0 + 4 * g;
      int v = 0;
      if (j < nb && w < width) {
        const int8_t* xp = x8 + (size_t)(b0 + j) * K + (size_t)p * width + w;
        if (vec) {
          v = __ldg(reinterpret_cast<const int*>(xp));
        } else {
          int t[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) t[i] = w + i < width ? xp[i] : 0;
          v = pack4(t[0], t[1], t[2], t[3]);
        }
      }
      xs8[e] = v;
    }
    __syncthreads();
    // every lane takes part in the reductions: lanes past width or rows
    // past M contribute zero codes against zero activations
    const bool live = m0 < M && w0 + 4 * lane < width;
    uint32_t wd[kRows][4] = {};
    if (live) load_words(qw, m0, M, width, w0 + 4 * lane, vec, wd);
    if (m0 >= M) continue;   // uniform across the warp
#pragma unroll
    for (int p = 0; p < C::kPf; ++p) {
      // the chunk's span of plane p lies inside one group (wrapper's gate)
      const int g = (p * width + w0) / gs;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int cp = pack4(C::at(wd[r][0], p) - kCentre,
                             C::at(wd[r][1], p) - kCentre,
                             C::at(wd[r][2], p) - kCentre,
                             C::at(wd[r][3], p) - kCentre);
        const float s = __ldg(scales + (size_t)min(m0 + r, M - 1) * G + g);
#pragma unroll
        for (int j = 0; j < TB; ++j) {
          int d = live ? __dp4a(xs8[(j * C::kPf + p) * kChunkQ + lane], cp, 0)
                       : 0;
          d = __reduce_add_sync(0xffffffffu, d);
          acc[r][j] = fmaf(s, (float)d, acc[r][j]);
        }
      }
    }
  }

  if (lane == 0 && m0 < M)
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < TB; ++j)
        if (j < nb && m0 + r < M)
          store(out + (size_t)(b0 + j) * M + m0 + r, acc[r][j] * sx[b0 + j]);
}

template <typename OT, int BITS, int TB>
cudaError_t launch_a8(const void* x8, const void* sx, const void* sumx,
                      const void* qw, const void* scales, const void* zeros,
                      void* out, int B, int M, int width, int G, int gs,
                      cudaStream_t stream) {
  const auto kernel = uniform_a8_gemv_kernel<OT, BITS, TB>;
  const size_t smem = sizeof(int) * TB * Codes<BITS>::kPf * kChunkQ;
  const int rows_per_block = kWarps * kRows;
  const dim3 grid((M + rows_per_block - 1) / rows_per_block,
                  (B + TB - 1) / TB);
  kernel<<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const int8_t*>(x8), static_cast<const float*>(sx),
      static_cast<const int32_t*>(sumx), static_cast<const int32_t*>(qw),
      static_cast<const float*>(scales), static_cast<const float*>(zeros),
      static_cast<OT*>(out), B, M, width, G, gs);
  return cudaSuccess;
}

template <typename OT, int BITS>
cudaError_t a8_tiles(const void* x8, const void* sx, const void* sumx,
                     const void* qw, const void* scales, const void* zeros,
                     void* out, int B, int M, int width, int G, int gs,
                     cudaStream_t s) {
  if (B == 1)
    return launch_a8<OT, BITS, 1>(x8, sx, sumx, qw, scales, zeros, out, B, M,
                                  width, G, gs, s);
  if (B == 2)
    return launch_a8<OT, BITS, 2>(x8, sx, sumx, qw, scales, zeros, out, B, M,
                                  width, G, gs, s);
  if (B <= 4)
    return launch_a8<OT, BITS, 4>(x8, sx, sumx, qw, scales, zeros, out, B, M,
                                  width, G, gs, s);
  return launch_a8<OT, BITS, kMaxTB>(x8, sx, sumx, qw, scales, zeros, out, B,
                                     M, width, G, gs, s);
}

template <typename OT>
cudaError_t a8_bits(const void* x8, const void* sx, const void* sumx,
                    const void* qw, const void* scales, const void* zeros,
                    void* out, int B, int M, int width, int G, int gs,
                    int bits, cudaStream_t s) {
  switch (bits) {
    case 2: return a8_tiles<OT, 2>(x8, sx, sumx, qw, scales, zeros, out, B, M, width, G, gs, s);
    case 3: return a8_tiles<OT, 3>(x8, sx, sumx, qw, scales, zeros, out, B, M, width, G, gs, s);
    case 4: return a8_tiles<OT, 4>(x8, sx, sumx, qw, scales, zeros, out, B, M, width, G, gs, s);
    case 8: return a8_tiles<OT, 8>(x8, sx, sumx, qw, scales, zeros, out, B, M, width, G, gs, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [B, width * packfactor] (bf16 if x_bf16 else f32), qw [M, width] int32,
// scales [M, G] f32, zeros [M, G] f32 or null (symmetric: the centre
// 2^(bits-1)), gidx [K] int32 or null (sequential: column / gs), out [B, M]
// in x's type; all contiguous, x and qw 16-byte aligned. Returns the
// cudaError_t of the launch.
extern "C" int ganq_uniform_matmul(const void* x, const void* qw,
                                   const void* scales, const void* zeros,
                                   const void* gidx, void* out, int B, int M,
                                   int width, int G, int gs, int bits,
                                   int x_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_bf16 ? uniform_bits<bf16>(x, qw, scales, zeros, gidx, out, B, M,
                                  width, G, gs, bits, s)
             : uniform_bits<float>(x, qw, scales, zeros, gidx, out, B, M,
                                   width, G, gs, bits, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// x [B, K = width * packfactor] (bf16 if x_bf16 else f32); scratch x8
// [B, K] int8, sx [B] f32, sumx [B, G] int32; qw [M, width] int32, scales
// [M, G] f32, zeros [M, G] f32 or null (symmetric: the centre 2^(bits-1));
// out [B, M] in x's type. Groups are sequential, gs = K /
// G, and every 128-word span of a plane lies inside one group. Two launches
// (activation quantization, then the int8 GEMV) on the stream.
extern "C" int ganq_uniform_a8_matmul(const void* x, const void* qw,
                                      const void* scales, const void* zeros,
                                      void* x8, void* sx, void* sumx,
                                      void* out, int B, int M, int width,
                                      int G, int bits, int x_bf16,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pf = 32 / (bits == 3 ? 4 : bits);
  const int K = width * pf;
  const int gs = K / G;
  cudaError_t err = launch_quant(x, x_bf16, B, K, x8, sx, sumx, G, gs, s);
  if (err != cudaSuccess) return (int)err;
  err = x_bf16 ? a8_bits<bf16>(x8, sx, sumx, qw, scales, zeros, out, B, M, width,
                               G, gs, bits, s)
               : a8_bits<float>(x8, sx, sumx, qw, scales, zeros, out, B, M, width,
                                G, gs, bits, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
