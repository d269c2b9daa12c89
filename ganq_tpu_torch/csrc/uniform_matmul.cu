// Uniform (scale / zero-point) dequant matrix products for Hopper (sm_90a).
//
// Replaces two kernels of ganq_tpu/ops/uniform_matmul.py:
//
// * uniform_matmul (Pallas kernel _uniform_kernel, pallas_call at :100, a
//   bf16 MXU dot per plane), entry ganq_uniform_matmul:
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
// * uniform_a8_matmul (Pallas kernel _uniform_a8_kernel, pallas_call at
//   :244, int8 MXU dots per 128-column group), entry
//   ganq_uniform_a8_matmul: per token row sx = max(max|x| * fl(1/127),
//   1e-12) and x8 = clamp(rint(x / sx), -127, 127) (a8_quant.cuh, the rule
//   of every int8-activation kernel), then per group an exact int32 dot of x8 with the codes
//   (8-bit codes centred by 128 to fit int8, the offset folded into the
//   zero side: z' = z - 128), and
//
//     out[b, m] = sx[b] * (sum_g s_g * dot_g - sum_g s_g z'_g * sum(x8)_g),
//
//   s_g z'_g formed in float32 as s_g * (z_g - zoff), as the JAX wrapper
//   forms it. Sequential groups whose 128-column spans of a plane lie inside
//   one group (the wrapper's copy of the TPU gate guarantees it).
//
// Codes are planar-packed in int32 words (ops/packing.py): bit-slot p of
// word w of row m holds the code of column p * width + w; 3-bit codes take
// a nibble. So consecutive words of a row hold consecutive columns of one
// plane, a 128-word span of a plane is one 128-column group, and a thread
// that loads words w, w + 1 holds a k-pair of every plane.
//
// Bounds on an H100 SXM. Bytes: the packed codes, M * K * bits / 8, plus
// the float32 scales, x and the output, over 3.35 TB/s. Operations:
// 2 * B * M * K over 989 TFLOP/s (bf16 tensor cores) or 1979 TOP/s (int8).
// At 4 bits and decode batch the bytes bind: 3.35 TB/s * 2 weights a byte
// / 132 SMs / ~1.75 GHz is ~29 weights an SM-cycle against 128 lane
// instructions an SM-cycle, a budget of ~4.4 instructions a weight at the
// bound and ~8.8 at half of it.
//
// The C entries choose a path by shape before the launch:
//
// 1. Decode, B <= 8 token rows, kernel 5 with bf16 x (uniform_tc_decode)
//    and kernel 6 (uniform_a8_tc_decode). A warp owns 8 output rows and a
//    128-word chunk: the rows are the N side of mma.sync m16n8k16 bf16
//    (kernel 5) or m16n8k32 s8 (kernel 6), the token rows its M side, so a
//    weight costs its decode and no per-token FMA. A block holds up to 8
//    such warps (rt row tiles x a split of K's chunks); the block stages
//    the split's x (or x8) columns in shared memory with cp.async and the
//    warps' scales in tables, all issued after the warps' packed words
//    (4 KB a warp, 8- or 16-byte loads) and before one wait; warps sharing
//    a row tile add their sums in chunk order in shared memory. K is split
//    over blocks, with a second launch adding the partial sums in split
//    order, when the row tiles fill less than a wave of the card (k/v's M
//    = 512 at B = 1) or the x slice would not fit 46 KB. Kernel 5 reads a
//    code as an exact float with one LOP3 (the field ORed into the
//    mantissa of 2^23) and one FMA whose addend, -(2^(23-o) + z), also
//    subtracts the zero where that addend is exact (checked per warp: it
//    is for integer zeros and the symmetric centre), then multiplies by s
//    and rounds pairs to bf16 with one cvt: ~3.5 instructions a weight.
//    The scale and zero are read once per (row, plane, chunk) when groups
//    are sequential multiples of 128 columns and planes multiples of 128
//    words; g_idx and short groups look them up per column. Kernel 6
//    gathers a plane's codes of four words into int8 lanes with three
//    byte permutes and a shift-mask; the tensor core forms each 128-column
//    group's int32 dot over four k32 steps, exactly, and s_g scales it into
//    the float sum once, the zero side -sumx_g * s_g z'_g at the group's
//    first chunk.
// 2. Prefill, 9-1023 token rows: tiled GEMMs on mma.sync. A block owns 64
//    output rows (four warps of 16) and BN token rows; x (or x8) tiles
//    come through cp.async rings and reach the mma as B fragments through
//    ldmatrix, and each warp decodes its A fragments (16 rows) in
//    registers and uses each for BN / 8 products. Kernel 5 with bf16 x
//    (uniform_tc_tile): m16n8k16 bf16, a two-stage ring of a 16-word span
//    of every plane, the words and (s, z) read a span ahead, BN = 32 up to
//    48 token rows, else 64. Kernel 5 with float32 x from 41 token rows
//    (uniform_f32_tile): float32 FMAs on the CUDA cores (the TPU kernel runs Precision.HIGHEST
//    there; TF32 would change the numbers), 64 x 64 tiles of dequantized
//    weights and x in shared memory, each weight used for 64 token rows.
//    Kernel 6 (uniform_a8_tc_tile): m16n8k32 s8, BN = 32 up to 32 token
//    rows, else 64; a four-stage ring walks (chunk, plane) steps, a
//    chunk's words land in shared memory a chunk ahead and stay in
//    registers for all its planes, and each plane's group dot accumulates
//    in int32 over four k32 steps before s_g scales it in, group by group.
//    K is split over blocks, and a second launch adds the partial sums in
//    split order, to about 4 x 132 blocks (kernel 5) or 192 (kernel 6)
//    while fewer than half as many would run: a warp's 16 rows of decoding
//    and dependent products leave a lone warp latency-bound, and more of
//    kernel 6's partial sums cost more than its extra warps gain. (A
//    warpgroup wgmma version of both tiles, with the same A fragments in
//    registers, was built and not kept; no committed script times it.)
//
// The GEMV kernels (uniform_gemv_kernel, uniform_a8_gemv_kernel) take the
// remaining shapes: kernel 5 with float32 x at up to 40 token rows (the
// tile reuses a weight over 64 rows, which a decode batch does not fill)
// and with a plane width that is no multiple of 16 words (for example 9
// words, one group), kernel 6 with a plane width that
// is no multiple of 128 words (the gate admits those at M <= 8 only). A
// warp owns kRows output rows, its lanes stride over 16-byte groups of
// packed words, a chunk of x (or x8) is staged in shared memory per block,
// and token rows come in tiles of kMaxTB per block row.

#include "mma_sync.cuh"

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

// ------------------------------------------------- the GEMV, kernel 5
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

// ------------------------------------------------- the GEMV, kernel 6
// (the activation quantization, quant_rows_a8_kernel, is in a8_quant.cuh)

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

// ------------------------------------------------------ tensor-core paths
__device__ __forceinline__ uint2 ldg2(const int32_t* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ uint4 ldg4(const int32_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}
// an int32 group dot as a float, exactly: |d| < 2^22 (128 columns of
// |x8| <= 127 and |code| <= 128), so d + 0x4B400000 is the bit pattern of
// 2^23 + 2^22 + d; one integer add and one float add, on full-rate pipes
__device__ __forceinline__ float i2f(int d) {
  return __int_as_float(d + 0x4B400000) - 12582912.f;
}

// the codes in bit-slot p of four words as four int8 lanes (8-bit codes
// centred by 128): byte (slot * p) / 8 of each word gathered by three byte
// permutes, then one shift and mask
template <int BITS>
__device__ __forceinline__ uint32_t plane4(const uint4& w, int p) {
  using C = Codes<BITS>;
  const int o = C::kSlot * p;
  const unsigned b = (unsigned)o >> 3;
  const unsigned sel = b | ((b + 4) << 4);
  const uint32_t lo = __byte_perm(w.x, w.y, sel);
  const uint32_t hi = __byte_perm(w.z, w.w, sel);
  uint32_t v = (__byte_perm(lo, hi, 0x5410) >> (o & 7)) &
               (C::kMask * 0x01010101u);
  if (BITS == 8) v ^= 0x80808080u;
  return v;
}

// (scale, zero) of row r at column col, through the column -> group map
__device__ __forceinline__ float2 sz_col(const float* __restrict__ scales,
                                         const float* __restrict__ zeros,
                                         const int32_t* __restrict__ gidx,
                                         int r, int col, int G, int gs,
                                         float center) {
  const int g = gidx ? __ldg(gidx + col) : col / gs;
  const size_t i = (size_t)r * G + g;
  return make_float2(__ldg(scales + i), zeros ? __ldg(zeros + i) : center);
}

constexpr int kDecWarps = 8;     // most warps of a decode block
constexpr int kDecChunk = 128;   // words of a row a warp takes at a time
constexpr int kTileWarps = 4;    // a tile block: 4 warps x 16 rows
constexpr int kTileRows = 16 * kTileWarps;

// the two sums of each lane of the per warps of a decode block that share
// a row tile (a chunk each), added in chunk order by the first of them,
// which gets them back in acc
__device__ __forceinline__ bool reduce_warps(float (&acc)[2], int warp,
                                             int lane, int per) {
  __shared__ float red[kDecWarps][2][32];
  if (per == 1) return true;
  red[warp][0][lane] = acc[0];
  red[warp][1][lane] = acc[1];
  __syncthreads();
  if (warp % per != 0) return false;
  for (int w = 1; w < per; ++w) {
    acc[0] += red[warp + w][0][lane];
    acc[1] += red[warp + w][1][lane];
  }
  return true;
}

// a decode block's sums (token g, rows m0 + 2t and + 1): to the output
// (times sx for kernel 6) or to this split's partial sums
__device__ __forceinline__ void store_decode(const float (&acc)[2], int m0,
                                             int lane, int B, int M,
                                             void* out, int out_bf16,
                                             float* part, const float* sx) {
  const int n = lane >> 2, row = m0 + 2 * (lane & 3);
  if (n >= B) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row + i >= M) continue;
    const size_t o = (size_t)n * M + row + i;
    if (part)
      part[(size_t)blockIdx.y * B * M + o] = acc[i];
    else
      store_out(out, out_bf16, o, sx ? acc[i] * __ldg(sx + n) : acc[i]);
  }
}

// The decode kernels: a block owns 8 output rows (the N side of the mma;
// the token rows are its M side, rows 8-15 zero) and a split of at most
// kDecWarps of K's 128-word chunks, a warp each. A warp first issues the
// loads of its chunk's packed words (4 KB: 8 rows of 512 bytes) into
// registers, the block then stages its split's x columns in shared memory
// with cp.async (at most kDecSmem bytes, which bounds the split) and each
// warp reads its scales before the one wait; the products then run on
// registers and shared memory alone.
// dynamic shared memory of a decode block at most (with the 2 KB of
// reduce_warps under the 48 KB a block gets without opting in)
constexpr int kDecSmem = 46 * 1024;

// row n of the staged x slice: per chunk and plane 128 columns, padded by
// 16 bytes so the eight token rows fall in distinct banks
__device__ __forceinline__ int dec_row_bytes(int per, int pf, int esize) {
  return per * pf * kDecChunk * esize + 16;
}

template <typename T, int PF>
__device__ __forceinline__ void stage_dec_slice(unsigned char* xs,
                                                const T* __restrict__ x,
                                                int B, int width, int c0,
                                                int per, int nch) {
  const int row = dec_row_bytes(per, PF, (int)sizeof(T));
  constexpr int kPer16 = kDecChunk * (int)sizeof(T) / 16;   // 16-B pieces
  const int total = per * PF * kPer16;
  const size_t K = (size_t)width * PF;
  for (int n = 0; n < B; ++n)
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int h = e % kPer16, cp = e / kPer16;
      const int c = c0 + cp / PF, p = cp % PF;
      const bool ok =
          c < nch && c * kDecChunk + h * (16 / (int)sizeof(T)) < width;
      const T* src = x + (size_t)n * K + (size_t)p * width +
                     (size_t)(ok ? c : 0) * kDecChunk;
      cp_async16(xs + n * row + cp * kDecChunk * (int)sizeof(T) + h * 16,
                 reinterpret_cast<const unsigned char*>(src) + h * 16, ok);
    }
  cp_async_commit();
}

// a compile-time integer handed to a generic lambda
template <int V> struct Const {
  static constexpr int value = V;
};

// The code in bit-slot p of a word as an exact float: the field (read
// from word >> 16 when it ends above bit 23), ORed into the mantissa of
// 2^23, is 2^23 + q * 2^o, and one FMA by 2^-o less 2^(23-o) leaves q.
// Field holds, for plane p, the word's shift, the field's mask and the
// FMA's two constants.
struct Field {
  int sh;
  uint32_t mask;
  float scale, off;
};
template <int BITS>
__device__ __forceinline__ Field field_of(int p) {
  using C = Codes<BITS>;
  const int o = C::kSlot * p;
  const int sh = o + C::kSlot <= 23 ? 0 : 16, oo = o - sh;
  return Field{sh, C::kMask << oo, __uint_as_float((uint32_t)(127 - oo) << 23),
               -__uint_as_float((uint32_t)(150 - oo) << 23)};
}
__device__ __forceinline__ float code_at(uint32_t word, const Field& f) {
  return fmaf(__uint_as_float(0x4B000000u | ((word >> f.sh) & f.mask)),
              f.scale, f.off);
}

// planes whose field ends at or below bit 23 of the word (field_of reads the
// others from word >> 16)
template <int BITS> struct LowPlanes {
  static constexpr int kAll =
      (23 - Codes<BITS>::kSlot) / Codes<BITS>::kSlot + 1;
  static constexpr int kN = kAll < Codes<BITS>::kPf ? kAll : Codes<BITS>::kPf;
};

// kernel 5 decode, bf16 x. mode 0: one (s, z) per (row, plane, chunk),
// read into a table; when every zero of a warp's table makes 2^(23-o) + z
// exact, (q - z) comes from the one FMA that decodes the field (its addend
// -(2^(23-o) + z)), equal to float(q) - z, and a weight costs a LOP3, that
// FMA, the product by s and half a cvt. mode 1: a (s, z) lookup per column.
template <int BITS>
__global__ void __launch_bounds__(kDecWarps * 32)
uniform_tc_decode(const bf16* __restrict__ x, const int32_t* __restrict__ qw,
                  const float* __restrict__ scales,
                  const float* __restrict__ zeros,
                  const int32_t* __restrict__ gidx, bf16* __restrict__ out,
                  float* __restrict__ part, int B, int M, int width, int G,
                  int gs, int mode, int per) {
  using C = Codes<BITS>;
  constexpr int kLow = LowPlanes<BITS>::kN;
  extern __shared__ __align__(16) unsigned char dec_x[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rt = (blockDim.x >> 5) / per, cl = warp % per;
  const int m0 = (blockIdx.x * rt + warp / per) * 8;
  const int r = min(m0 + g, M - 1);   // this lane's weight row
  const float center = (float)(1 << (BITS - 1));
  const int nch = (width + kDecChunk - 1) / kDecChunk;
  const int c0 = blockIdx.y * per, c = c0 + cl, w0 = c * kDecChunk;
  // spans of this warp's chunk
  const int nsp = c < nch && m0 < M ? min(8, (width - w0) / 16) : 0;
  const int xrow = dec_row_bytes(per, C::kPf, 2);
  // after the x slice: each warp's (s, z) of its 8 rows
  float2* szt = reinterpret_cast<float2*>(dec_x + B * xrow) + warp * 8 * C::kPf;

  // this warp's chunk: per 16-word span, words 2t, 2t+1 and 8+2t, 9+2t of
  // row r
  uint2 wd[8][2];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    if (s < nsp) {
      const int32_t* q = qw + (size_t)r * width + w0 + 16 * s;
      wd[s][0] = ldg2(q + 2 * t);
      wd[s][1] = ldg2(q + 8 + 2 * t);
    } else {
      wd[s][0] = wd[s][1] = make_uint2(0u, 0u);
    }
  }
  stage_dec_slice<bf16, C::kPf>(dec_x, x, B, width, c0, per, nch);
  bool exact = mode == 0;
  if (mode == 0 && nsp > 0)
    for (int e = lane; e < 8 * C::kPf; e += 32) {
      const int rr = min(m0 + e / C::kPf, M - 1), p = e % C::kPf;
      const size_t i = (size_t)rr * G + (p * width + w0) / gs;
      const float z = zeros ? __ldg(zeros + i) : center;
      const float off = field_of<BITS>(p).off;   // -2^(23-o)
      exact = exact && (z - off) + off == z;     // 2^(23-o) + z exact
      szt[e] = make_float2(__ldg(scales + i), z);
    }
  exact = __all_sync(0xffffffffu, exact);
  cp_async_wait<0>();
  __syncthreads();

  // two accumulators halve the chain of dependent products
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  const unsigned char* xr =
      dec_x + (g < B ? g : 0) * xrow + cl * C::kPf * kDecChunk * 2;
  const float2* tk = szt + g * C::kPf;
  // one plane over one half of the chunk's spans: x from the slice, the
  // weights as wt(s, i, word) makes them. Spans past the plane's width meet
  // zero x (the slice is zero-filled there), so only the per-column lookups
  // stop at the width.
  auto plane = [&](int p, auto wt, auto checked, auto half) {
    const uint32_t* xp =
        reinterpret_cast<const uint32_t*>(xr + p * kDecChunk * 2) + t;
#pragma unroll
    for (int s = 4 * decltype(half)::value; s < 4 * decltype(half)::value + 4;
         ++s) {
      if (decltype(checked)::value && s >= nsp) break;   // warp-uniform
      const uint32_t a[4] = {g < B ? xp[8 * s] : 0u, 0u,
                             g < B ? xp[8 * s + 4] : 0u, 0u};
      const uint32_t b0 =
          pack_bf16(wt(s, 0, wd[s][0].x), wt(s, 1, wd[s][0].y));
      const uint32_t b1 =
          pack_bf16(wt(s, 2, wd[s][1].x), wt(s, 3, wd[s][1].y));
      mma_bf16(acc[s & 1], a, b0, b1);
    }
  };
  // every plane over one half of the spans: the first half's products run
  // while the second half's words are still arriving
  auto planes = [&](auto half) {
    if (nsp > 0 && exact) {
      // low planes read the words as they are, the others word >> 16
#pragma unroll 1
      for (int p = 0; p < kLow; ++p) {
        const Field f = field_of<BITS>(p);
        const float2 sz = tk[p];
        const float add = f.off - sz.y;   // -(2^(23-o) + z), exact
        plane(p, [&](int, int, uint32_t u) {
          return fmaf(__uint_as_float(0x4B000000u | (u & f.mask)), f.scale,
                      add) * sz.x;
        }, Const<0>(), half);
      }
#pragma unroll 1
      for (int p = kLow; p < C::kPf; ++p) {
        const Field f = field_of<BITS>(p);
        const float2 sz = tk[p];
        const float add = f.off - sz.y;   // -(2^(23-o) + z), exact
        plane(p, [&](int, int, uint32_t u) {
          return fmaf(__uint_as_float(0x4B000000u | ((u >> 16) & f.mask)),
                      f.scale, add) * sz.x;
        }, Const<0>(), half);
      }
    } else if (nsp > 0) {
#pragma unroll 1
      for (int p = 0; p < C::kPf; ++p) {
        const Field f = field_of<BITS>(p);
        const float2 sz = mode == 0 ? tk[p] : make_float2(0.f, 0.f);
        plane(p, [&](int s, int i, uint32_t u) {
          float2 q = sz;
          if (mode != 0)
            q = sz_col(scales, zeros, gidx, r,
                       p * width + w0 + 16 * s + 2 * t + (i & 1) + 8 * (i >> 1),
                       G, gs, center);
          return (code_at(u, f) - q.y) * q.x;
        }, Const<1>(), half);
      }
    }
  };
  planes(Const<0>());
  planes(Const<1>());

  // token g; acc[.][2..3] are token g + 8
  float two[2] = {acc[0][0] + acc[1][0], acc[0][1] + acc[1][1]};
  if (!reduce_warps(two, warp, lane, per)) return;
  store_decode(two, m0, lane, B, M, out, 1, gridDim.y > 1 ? part : nullptr,
               nullptr);
}

// kernel 6 decode: width a multiple of 128 words; zside says whether the
// zero side is nonzero (zeros given, or fewer than 8 bits)
template <int BITS>
__global__ void __launch_bounds__(kDecWarps * 32)
uniform_a8_tc_decode(const int8_t* __restrict__ x8,
                     const float* __restrict__ sx,
                     const int32_t* __restrict__ sumx,
                     const int32_t* __restrict__ qw,
                     const float* __restrict__ scales,
                     const float* __restrict__ zeros, void* __restrict__ out,
                     int out_bf16, float* __restrict__ part, int B, int M,
                     int width, int G, int gs, int zside, int per) {
  using C = Codes<BITS>;
  constexpr float kCentre = BITS == 8 ? 128.f : 0.f;
  constexpr float kSym = (float)(1 << (BITS - 1));
  extern __shared__ __align__(16) unsigned char dec_x[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rt = (blockDim.x >> 5) / per, cl = warp % per;
  const int m0 = (blockIdx.x * rt + warp / per) * 8;
  const int r = min(m0 + g, M - 1);   // this lane's weight row
  const int nch = width / kDecChunk;
  const int c0 = blockIdx.y * per, c = c0 + cl, w0 = c * kDecChunk;
  const bool live = c < nch && m0 < M;
  const int xrow = dec_row_bytes(per, C::kPf, 1);
  // after the x slice: per warp and plane, the group scale s and zero side
  // s * z' of its 8 rows and the group sums of x8 of its token rows
  float* tab = reinterpret_cast<float*>(dec_x + B * xrow) + warp * 24 * C::kPf;

  // this warp's chunk: per 32-word span, words 4t..4t+3 and 16+4t..
  uint4 wd[4][2];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int32_t* q = qw + (size_t)r * width + (live ? w0 : 0) + 32 * s;
    wd[s][0] = ldg4(q + 4 * t);
    wd[s][1] = ldg4(q + 16 + 4 * t);
  }
  stage_dec_slice<int8_t, C::kPf>(dec_x, x8, B, width, c0, per, nch);
  if (live)
    for (int e = lane; e < 8 * C::kPf; e += 32) {
      const int k = e / C::kPf, p = e % C::kPf;
      const int rr = min(m0 + k, M - 1), cb = p * width + w0, grp = cb / gs;
      const size_t i = (size_t)rr * G + grp;
      const float sc = __ldg(scales + i);
      // the group's zero side, at its first chunk
      const bool first = zside && cb % gs == 0;
      tab[e] = sc;
      tab[8 * C::kPf + e] =
          first ? sc * ((zeros ? __ldg(zeros + i) : kSym) - kCentre) : 0.f;
      tab[16 * C::kPf + e] =
          first && k < B ? (float)__ldg(sumx + (size_t)k * G + grp) : 0.f;
    }
  cp_async_wait<0>();
  __syncthreads();

  float acc[2] = {0.f, 0.f};
  if (live) {
    const unsigned char* xr =
        dec_x + (g < B ? g : 0) * xrow + cl * C::kPf * kDecChunk;
    // each plane's group dot in int32 over the chunk's four k32 spans, the
    // first two spans of every plane before the last two, so the products
    // start while the second half's words are still arriving
    int d[C::kPf][4];
#pragma unroll
    for (int p = 0; p < C::kPf; ++p)
#pragma unroll
      for (int k = 0; k < 4; ++k) d[p][k] = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int p = 0; p < C::kPf; ++p) {
        const uint32_t* xp =
            reinterpret_cast<const uint32_t*>(xr + p * kDecChunk) + t;
#pragma unroll
        for (int s = 2 * h; s < 2 * h + 2; ++s) {
          const uint32_t a[4] = {g < B ? xp[8 * s] : 0u, 0u,
                                 g < B ? xp[8 * s + 4] : 0u, 0u};
          mma_s8(d[p], a, plane4<BITS>(wd[s][0], p),
                 plane4<BITS>(wd[s][1], p));
        }
      }
#pragma unroll
    for (int p = 0; p < C::kPf; ++p) {
      // the chunk's 128 columns of plane p lie in one group: rows 2t, 2t+1
      const float* ta = tab + 2 * t * C::kPf + p;
      const float xz = tab[16 * C::kPf + g * C::kPf + p];
      acc[0] = fmaf(ta[0], i2f(d[p][0]), acc[0]);
      acc[1] = fmaf(ta[C::kPf], i2f(d[p][1]), acc[1]);
      acc[0] = fmaf(-xz, ta[8 * C::kPf], acc[0]);
      acc[1] = fmaf(-xz, ta[9 * C::kPf], acc[1]);
    }
  }

  if (!reduce_warps(acc, warp, lane, per)) return;
  store_decode(acc, m0, lane, B, M, out, out_bf16,
               gridDim.y > 1 ? part : nullptr, sx);
}

// a tile block's sums: to the output (times sx for kernel 6), or, when K is
// split over blocks, to this split's float32 partial sums
template <int NT>
__device__ __forceinline__ void store_tile(const float (&acc)[NT][4], int m0,
                                           int n0, int lane, int B, int M,
                                           void* out, int out_bf16,
                                           float* part, const float* sx) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + g + ((i >> 1) << 3);
      const int n = n0 + 8 * j + 2 * t + (i & 1);
      if (row >= M || n >= B) continue;
      const size_t o = (size_t)n * M + row;
      if (part)
        part[(size_t)blockIdx.z * B * M + o] = acc[j][i];
      else
        store_out(out, out_bf16, o, sx ? acc[j][i] * __ldg(sx + n) : acc[j][i]);
    }
}

// the staged x row of one token: a 16-word span of every plane, padded by
// 16 bytes so ldmatrix's eight rows fall in distinct banks
template <int BITS> struct TileX {
  static constexpr int kRow = Codes<BITS>::kPf * 16 + 8;   // bf16
};

// kernel 5 tile, bf16 x: 64 rows x 8 * NT token rows a block. A span's
// x tile lands in a two-stage ring and its packed words in registers one
// span ahead; span_seq says a span of a plane lies in one group (no g_idx,
// gs a multiple of 16), and then each warp's (s, z) of its 16 rows at every
// plane are read one span ahead into a table in shared memory; otherwise
// each column looks its group up.
template <int BITS, int NT>
__global__ void __launch_bounds__(kTileWarps * 32)
uniform_tc_tile(const bf16* __restrict__ x, const int32_t* __restrict__ qw,
                const float* __restrict__ scales,
                const float* __restrict__ zeros,
                const int32_t* __restrict__ gidx, bf16* __restrict__ out,
                float* __restrict__ part, int B, int M, int width, int G,
                int gs, int span_seq, int spans_per_split) {
  using C = Codes<BITS>;
  constexpr int BN = 8 * NT;
  constexpr int kRow = TileX<BITS>::kRow;
  constexpr int kSz = 16 * C::kPf / 32;   // (s, z) pairs a lane reads
  extern __shared__ __align__(16) unsigned char ring16[];
  bf16* xs = reinterpret_cast<bf16*>(ring16);   // [2][BN][kRow]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // [2][warps][16 rows][kPf] (s, z)
  float2* szt = reinterpret_cast<float2*>(xs + 2 * BN * kRow) +
                warp * 16 * C::kPf;
  const int m0 = blockIdx.x * kTileRows + warp * 16;
  const int n0 = blockIdx.y * BN;
  const size_t K = (size_t)width * C::kPf;
  const int sp0 = blockIdx.z * spans_per_split;
  const int sp1 = min(width / 16, sp0 + spans_per_split);
  const int r0 = min(m0 + g, M - 1), r1 = min(m0 + g + 8, M - 1);
  const int32_t* q0 = qw + (size_t)r0 * width;
  const int32_t* q1 = qw + (size_t)r1 * width;
  const float center = (float)(1 << (BITS - 1));
  const bool per_col = !span_seq;

  auto stage = [&](int sp, int buf) {
    bf16* dst = xs + buf * BN * kRow;
    const bf16* src = x + (size_t)sp * 16;
    for (int e = threadIdx.x; e < BN * C::kPf * 2; e += kTileWarps * 32) {
      const int h = e & 1, p = (e >> 1) % C::kPf, n = (e >> 1) / C::kPf;
      const bool ok = n0 + n < B;
      cp_async16(dst + n * kRow + p * 16 + h * 8,
                 src + (size_t)(ok ? n0 + n : 0) * K + (size_t)p * width + h * 8,
                 ok);
    }
  };
  auto words = [&](int sp, uint2 (&q)[4]) {
    const int w = sp * 16;
    q[0] = ldg2(q0 + w + 2 * t);
    q[1] = ldg2(q0 + w + 8 + 2 * t);
    q[2] = ldg2(q1 + w + 2 * t);
    q[3] = ldg2(q1 + w + 8 + 2 * t);
  };
  // this lane's share of the warp's (s, z) table for span sp
  auto sz_read = [&](int sp, float2 (&v)[kSz]) {
#pragma unroll
    for (int k = 0; k < kSz; ++k) {
      const int e = lane + 32 * k, p = e % C::kPf;
      const int rr = min(m0 + e / C::kPf, M - 1);
      const size_t i = (size_t)rr * G + (p * width + sp * 16) / gs;
      v[k] = make_float2(__ldg(scales + i), zeros ? __ldg(zeros + i) : center);
    }
  };
  auto sz_write = [&](int buf, const float2 (&v)[kSz]) {
#pragma unroll
    for (int k = 0; k < kSz; ++k)
      szt[buf * kTileWarps * 16 * C::kPf + lane + 32 * k] = v[k];
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  uint2 q[4], qn[4];
  float2 szn[kSz];
  if (sp0 < sp1) {
    words(sp0, q);
    stage(sp0, 0);
    if (!per_col) {
      sz_read(sp0, szn);
      sz_write(0, szn);
    }
  }
  cp_async_commit();
  for (int sp = sp0; sp < sp1; ++sp) {
    const int buf = (sp - sp0) & 1;
    const bool more = sp + 1 < sp1;
    if (more) {
      stage(sp + 1, buf ^ 1);
      words(sp + 1, qn);
      if (!per_col) sz_read(sp + 1, szn);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // span sp's x tile and (s, z) table are in place
    const bf16* xb = xs + buf * BN * kRow;
    const float2* sb = szt + buf * kTileWarps * 16 * C::kPf;
    const int w = sp * 16;
#pragma unroll 2
    for (int p = 0; p < C::kPf; ++p) {
      const Field f = field_of<BITS>(p);
      const uint32_t u[8] = {q[0].x, q[0].y, q[2].x, q[2].y,
                             q[1].x, q[1].y, q[3].x, q[3].y};
      float wv[8];
      if (!per_col) {
        const float2 a = sb[g * C::kPf + p], b = sb[(g + 8) * C::kPf + p];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float2 z = (k & 2) ? b : a;
          wv[k] = (code_at(u[k], f) - z.y) * z.x;
        }
      } else {
        const int ca = p * width + w + 2 * t;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float2 z = sz_col(scales, zeros, gidx, (k & 2) ? r1 : r0,
                                  ca + (k & 1) + 8 * (k >> 2), G, gs, center);
          wv[k] = (code_at(u[k], f) - z.y) * z.x;
        }
      }
      const uint32_t a[4] = {pack_bf16(wv[0], wv[1]), pack_bf16(wv[2], wv[3]),
                             pack_bf16(wv[4], wv[5]), pack_bf16(wv[6], wv[7])};
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, xb + (8 * j + (lane & 7) + ((lane >> 4) << 3)) * kRow +
                           p * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(acc[j], a, b[0], b[1]);
        mma_bf16(acc[j + 1], a, b[2], b[3]);
      }
    }
    if (more && !per_col) sz_write(buf ^ 1, szn);
    __syncthreads();   // this x buffer is refilled two spans on
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = qn[i];
  }
  store_tile<NT>(acc, m0, n0, lane, B, M, out, 1,
                 gridDim.z > 1 ? part : nullptr, nullptr);
}

// kernel 5 tile, float32 x: 64 rows x 64 token rows a block, 256 threads of
// 4 x 4 outputs, K in chunks of 128 columns (128 / packfactor words of
// every plane) dequantized once into shared memory
constexpr int kF32Tile = 64;
constexpr int kF32K = 128;
constexpr int kF32Ld = kF32Tile + 4;   // padded row of the k-major tiles

template <int BITS>
__global__ void __launch_bounds__(256)
uniform_f32_tile(const float* __restrict__ x, const int32_t* __restrict__ qw,
                 const float* __restrict__ scales,
                 const float* __restrict__ zeros,
                 const int32_t* __restrict__ gidx, float* __restrict__ out,
                 float* __restrict__ part, int B, int M, int width, int G,
                 int gs, int units_per_split) {
  using C = Codes<BITS>;
  constexpr int CW = kF32K / C::kPf;   // words of each plane per chunk
  extern __shared__ __align__(16) float tiles_f32[];
  float* xs = tiles_f32;                   // [kF32K][kF32Ld]: x by column
  float* ws = tiles_f32 + kF32K * kF32Ld;  // [kF32K][kF32Ld]: w by column
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * kF32Tile, n0 = blockIdx.y * kF32Tile;
  const size_t K = (size_t)width * C::kPf;
  const int nunits = (width + CW - 1) / CW;
  const int u0 = blockIdx.z * units_per_split;
  const int u1 = min(nunits, u0 + units_per_split);
  const float center = (float)(1 << (BITS - 1));

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[r][n] = 0.f;

  for (int u = u0; u < u1; ++u) {
    const int w0 = u * CW;
    __syncthreads();   // the previous chunk's tiles fully read
    for (int e = tid; e < kF32Tile * kF32K; e += 256) {
      const int n = e / kF32K, kk = e % kF32K;
      const int p = kk / CW, i = kk % CW;
      float v = 0.f;
      if (n0 + n < B && w0 + i < width)
        v = __ldg(x + (size_t)(n0 + n) * K + (size_t)p * width + w0 + i);
      xs[kk * kF32Ld + n] = v;
    }
    for (int e = tid; e < kF32Tile * CW; e += 256) {
      const int r = e / CW, i = e % CW;
      const int row = min(m0 + r, M - 1), w = w0 + i;
      const uint32_t word =
          w < width ? (uint32_t)__ldg(qw + (size_t)row * width + w) : 0u;
#pragma unroll
      for (int p = 0; p < C::kPf; ++p) {
        float v = 0.f;
        if (w < width) {
          const float2 sz =
              sz_col(scales, zeros, gidx, row, p * width + w, G, gs, center);
          v = (code_at(word, field_of<BITS>(p)) - sz.y) * sz.x;
        }
        ws[(p * CW + i) * kF32Ld + r] = v;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kF32K; ++kk) {
      const float4 xv =
          *reinterpret_cast<const float4*>(xs + kk * kF32Ld + 4 * tx);
      const float4 wv =
          *reinterpret_cast<const float4*>(ws + kk * kF32Ld + 4 * ty);
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
      const float wa[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[r][n] = fmaf(wa[r], xa[n], acc[r][n]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int row = m0 + 4 * ty + r, tok = n0 + 4 * tx + n;
      if (row >= M || tok >= B) continue;
      const size_t o = (size_t)tok * M + row;
      if (gridDim.z > 1)
        part[(size_t)blockIdx.z * B * M + o] = acc[r][n];
      else
        out[o] = acc[r][n];
    }
}

constexpr int kA8Stages = 4;
constexpr int kA8Row = 128 + 16;             // bytes of a staged x8 row
constexpr int kA8WordRow = kDecChunk + 16;   // words of a staged code row

// kernel 6 tile: 64 rows x 8 * NT token rows a block; width a multiple of
// 128 words. The steps walk the split's (chunk, plane) pairs: a ring of
// kA8Stages x8 tiles (one plane's 128 columns of the block's token rows)
// runs kA8Stages - 1 steps ahead, and the packed words of the next chunk
// (64 rows x 128 words) land in a second shared buffer during the current
// one; a warp copies its rows' words to registers at a chunk's first step
// and decodes every plane from them. A step's scales (and zero side) are
// read one step ahead.
template <int BITS, int NT>
__global__ void __launch_bounds__(kTileWarps * 32)
uniform_a8_tc_tile(const int8_t* __restrict__ x8,
                   const float* __restrict__ sx,
                   const int32_t* __restrict__ sumx,
                   const int32_t* __restrict__ qw,
                   const float* __restrict__ scales,
                   const float* __restrict__ zeros, void* __restrict__ out,
                   int out_bf16, float* __restrict__ part, int B, int M,
                   int width, int G, int gs, int zside,
                   int chunks_per_split) {
  using C = Codes<BITS>;
  constexpr int BN = 8 * NT;
  constexpr float kCentre = BITS == 8 ? 128.f : 0.f;
  constexpr float kSym = (float)(1 << (BITS - 1));
  // [kA8Stages][BN][kA8Row] x8 bytes, then [2][64][kA8WordRow] words
  extern __shared__ __align__(16) unsigned char ring8[];
  uint32_t* wbuf =
      reinterpret_cast<uint32_t*>(ring8 + kA8Stages * BN * kA8Row);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mb = blockIdx.x * kTileRows, m0 = mb + warp * 16;
  const int n0 = blockIdx.y * BN;
  const size_t K = (size_t)width * C::kPf;
  const int c0 = blockIdx.z * chunks_per_split;
  const int c1 = min(width / kDecChunk, c0 + chunks_per_split);
  const int nsteps = max(c1 - c0, 0) * C::kPf;
  const int r0 = min(m0 + g, M - 1), r1 = min(m0 + g + 8, M - 1);

  auto stage = [&](int i) {   // x8 of step i, and at a chunk's first step
    const int c = c0 + i / C::kPf, p = i % C::kPf;
    unsigned char* dst = ring8 + (i % kA8Stages) * (BN * kA8Row);
    const int8_t* src = x8 + (size_t)p * width + (size_t)c * kDecChunk;
    for (int e = threadIdx.x; e < BN * 8; e += kTileWarps * 32) {
      const int n = e >> 3, h = e & 7;
      const bool ok = n0 + n < B;
      cp_async16(dst + n * kA8Row + h * 16,
                 src + (size_t)(ok ? n0 + n : 0) * K + h * 16, ok);
    }
  };
  auto stage_words = [&](int c) {   // the packed words of chunk c
    uint32_t* dst = wbuf + ((c - c0) & 1) * kTileRows * kA8WordRow;
    for (int e = threadIdx.x; e < kTileRows * 32; e += kTileWarps * 32) {
      const int rr = e >> 5, h = e & 31;
      const int row = min(mb + rr, M - 1);
      cp_async16(dst + rr * kA8WordRow + h * 4,
                 qw + (size_t)row * width + (size_t)c * kDecChunk + h * 4,
                 true);
    }
  };
  // a step's group scales and zero side
  struct Meta {
    bool first;
    float s0, s1, z0, z1, xa[NT], xb[NT];
  };
  auto meta = [&](int i, Meta& m) {
    const int c = c0 + i / C::kPf, p = i % C::kPf;
    const int cb = p * width + c * kDecChunk, grp = cb / gs;
    m.s0 = __ldg(scales + (size_t)r0 * G + grp);
    m.s1 = __ldg(scales + (size_t)r1 * G + grp);
    const bool first = zside && cb % gs == 0;   // the group's first chunk
    m.first = first;
    m.z0 = first ? m.s0 * ((zeros ? __ldg(zeros + (size_t)r0 * G + grp)
                                  : kSym) - kCentre)
                 : 0.f;
    m.z1 = first ? m.s1 * ((zeros ? __ldg(zeros + (size_t)r1 * G + grp)
                                  : kSym) - kCentre)
                 : 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int na = n0 + 8 * j + 2 * t, nb = na + 1;
      m.xa[j] = first && na < B ? (float)__ldg(sumx + (size_t)na * G + grp)
                                : 0.f;
      m.xb[j] = first && nb < B ? (float)__ldg(sumx + (size_t)nb * G + grp)
                                : 0.f;
    }
  };

  if (nsteps > 0) stage_words(c0);
#pragma unroll
  for (int i = 0; i < kA8Stages - 1; ++i) {
    if (i < nsteps) stage(i);
    cp_async_commit();
  }

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  uint4 wd[4][4];
  // one step; its metadata was read a step ahead into use, and the next
  // step's is read into pre (two of them in turn, so no copy waits)
  auto step = [&](int i, const Meta& use, Meta& pre) {
    const int c = c0 + i / C::kPf, p = i % C::kPf;
    cp_async_wait<kA8Stages - 2>();
    __syncthreads();   // step i (and at p == 0 its words) landed; step
                       // i - 1's buffer is free
    if (p == 0) {      // the chunk's words, kept for all its planes
      const uint32_t* src = wbuf + ((c - c0) & 1) * kTileRows * kA8WordRow;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const uint32_t* a = src + (warp * 16 + g) * kA8WordRow + 32 * s + 4 * t;
        const uint32_t* b = a + 8 * kA8WordRow;
        wd[s][0] = *reinterpret_cast<const uint4*>(a);
        wd[s][1] = *reinterpret_cast<const uint4*>(a + 16);
        wd[s][2] = *reinterpret_cast<const uint4*>(b);
        wd[s][3] = *reinterpret_cast<const uint4*>(b + 16);
      }
    }
    if (i + kA8Stages - 1 < nsteps) stage(i + kA8Stages - 1);
    if (p == 0 && c + 1 < c1) stage_words(c + 1);
    cp_async_commit();
    if (i + 1 < nsteps) meta(i + 1, pre);
    const unsigned char* xb = ring8 + (i % kA8Stages) * (BN * kA8Row);
    int d[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) d[j][k] = 0;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint32_t a[4] = {plane4<BITS>(wd[s][0], p),
                             plane4<BITS>(wd[s][2], p),
                             plane4<BITS>(wd[s][1], p),
                             plane4<BITS>(wd[s][3], p)};
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, xb + (8 * j + (lane & 7) + ((lane >> 4) << 3)) * kA8Row +
                           s * 32 + ((lane >> 3) & 1) * 16);
        mma_s8(d[j], a, b[0], b[1]);
        mma_s8(d[j + 1], a, b[2], b[3]);
      }
    }
    // the chunk's 128 columns of plane p lie in one group: its int32 dots
    // scaled in, then, at the group's first chunk, its zero side
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] = fmaf(use.s0, i2f(d[j][0]), acc[j][0]);
      acc[j][1] = fmaf(use.s0, i2f(d[j][1]), acc[j][1]);
      acc[j][2] = fmaf(use.s1, i2f(d[j][2]), acc[j][2]);
      acc[j][3] = fmaf(use.s1, i2f(d[j][3]), acc[j][3]);
    }
    if (use.first) {   // uniform across the block
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[j][0] = fmaf(-use.xa[j], use.z0, acc[j][0]);
        acc[j][1] = fmaf(-use.xb[j], use.z0, acc[j][1]);
        acc[j][2] = fmaf(-use.xa[j], use.z1, acc[j][2]);
        acc[j][3] = fmaf(-use.xb[j], use.z1, acc[j][3]);
      }
    }
  };
  Meta ma, mb2;
  if (nsteps > 0) meta(0, ma);
  for (int i = 0; i < nsteps; i += 2) {
    step(i, ma, mb2);
    if (i + 1 < nsteps) step(i + 1, mb2, ma);
  }
  cp_async_wait<0>();
  store_tile<NT>(acc, m0, n0, lane, B, M, out, out_bf16,
                 gridDim.z > 1 ? part : nullptr, sx);
}

// ------------------------------------------------------------- planning
enum Path { kGemv, kDecode, kTileBf16, kTileF32 };

struct Plan {
  Path path = kGemv;
  int nt = 0;        // tile kernels: token rows / 8 of a block
  dim3 grid;
  int per = 0;       // K units (spans, chunks) a split takes
  int nsplit = 1;
  int smem = 0;      // decode: bytes of the staged x slice
};

int slot_bits(int bits) { return bits == 3 ? 4 : bits; }

// K split over blocks, to about `target` blocks, while fewer than half as
// many would run
void split_k(Plan& pl, int units, int min_per, int target) {
  const int blocks = (int)(pl.grid.x * pl.grid.y);
  int n = 2 * blocks >= target ? 1 : (target + blocks - 1) / blocks;
  n = max(1, min(n, units / max(min_per, 1)));
  pl.per = (units + n - 1) / n;
  pl.nsplit = (units + pl.per - 1) / pl.per;
  pl.grid.z = pl.nsplit;
}

// decode: blocks of rt tiles of 8 rows x a split of per chunks, a warp
// each. The split keeps the x slice (and every warp's tables) within
// kDecSmem and, while the row tiles fill less than one wave of the card,
// runs about two waves of blocks; rt > 1 lets one slice serve more rows
// (from 3 token rows, where re-reading x from L2 costs as much as the
// weights) while a wave of blocks still runs.
void plan_decode(Plan& pl, int B, int M, int nch, int pf, int esize) {
  pl.path = kDecode;
  const int tiles = (M + 7) / 8;
  const int fill = tiles >= 132 ? 1 : min(nch, (264 + tiles - 1) / tiles);
  // per warp and chunk: the (s, z) pairs of kernel 5 or the three float
  // tables of kernel 6, 8 rows x pf planes each
  const int table = 8 * pf * (esize == 2 ? 8 : 12);
  const int fit = (kDecSmem - kDecWarps * table - 16 * B) /
                  (B * pf * kDecChunk * esize);
  pl.per = max(1, min(min(fit, kDecWarps), (nch + fill - 1) / fill));
  pl.nsplit = (nch + pl.per - 1) / pl.per;
  int rt = B <= 2 ? 1 : min(4, kDecWarps / pl.per);
  while (rt > 1 && (tiles + rt - 1) / rt * pl.nsplit < 132) rt /= 2;
  pl.grid = dim3((tiles + rt - 1) / rt, pl.nsplit);
  pl.nt = rt * pl.per;   // warps of a block
  pl.smem = B * (pl.per * pf * kDecChunk * esize + 16) + pl.nt * table;
}

Plan plan_uniform(int B, int M, int width, int bits, int x_bf16) {
  Plan pl;
  if (width % 16 != 0 || B <= 0 || M <= 0) return pl;
  // float32 x up to 5 token tiles: the GEMV. On an H100 it took 0.23-0.42
  // of the float32 tile's time on the Llama-3.2-1B linears at B = 8 and
  // 0.48-0.99 at B = 33 (scripts/torch_port_uniform_ab.py --x-dtype
  // float32): the tile's time is flat up to 64 token rows, the GEMV's
  // grows with its token tiles once they fill the card
  if (!x_bf16 && B <= 5 * kMaxTB) return pl;
  const int mb = (M + kTileRows - 1) / kTileRows;
  if (x_bf16 && B <= 8) {
    plan_decode(pl, B, M, (width + kDecChunk - 1) / kDecChunk,
                32 / slot_bits(bits), 2);
    return pl;
  }
  if (x_bf16) {
    pl.path = kTileBf16;
    pl.nt = B <= 48 ? 4 : 8;
    pl.grid = dim3(mb, (B + 8 * pl.nt - 1) / (8 * pl.nt), 1);
    split_k(pl, width / 16, 8, 4 * 132);
  } else {
    pl.path = kTileF32;
    const int cw = kF32K / (32 / slot_bits(bits));
    pl.grid = dim3((M + kF32Tile - 1) / kF32Tile,
                   (B + kF32Tile - 1) / kF32Tile, 1);
    split_k(pl, (width + cw - 1) / cw, 2, 4 * 132);
  }
  return pl;
}

Plan plan_a8(int B, int M, int width, int bits) {
  Plan pl;
  if (width % kDecChunk != 0 || B <= 0 || M <= 0) return pl;
  const int nch = width / kDecChunk;
  if (B <= 8) {
    plan_decode(pl, B, M, nch, 32 / slot_bits(bits), 1);
    return pl;
  }
  pl.path = kTileBf16;   // the int8 tile
  pl.nt = B <= 32 ? 4 : 8;
  pl.grid = dim3((M + kTileRows - 1) / kTileRows,
                 (B + 8 * pl.nt - 1) / (8 * pl.nt), 1);
  split_k(pl, nch, 1, 192);
  return pl;
}

int scratch_floats(const Plan& pl, int B, int M) {
  return pl.nsplit > 1 ? pl.nsplit * B * M : 0;
}

cudaError_t sum_splits(const Plan& pl, const float* part, int B, int M,
                       const float* sx, void* out, int out_bf16,
                       cudaStream_t s) {
  if (pl.nsplit <= 1) return cudaSuccess;
  return launch_sum_splits(part, pl.nsplit, B, M, sx, out, out_bf16, s);
}

template <int BITS, int NT>
cudaError_t launch_tc_tile(const Plan& pl, const void* x, const void* qw,
                           const void* scales, const void* zeros,
                           const void* gidx, void* out, float* part, int B,
                           int M, int width, int G, int gs, int span_seq,
                           cudaStream_t s) {
  const auto kernel = uniform_tc_tile<BITS, NT>;
  const size_t smem = sizeof(bf16) * 2 * 8 * NT * TileX<BITS>::kRow +
                      sizeof(float2) * 2 * kTileRows * Codes<BITS>::kPf;
  static bool raised = false;
  const cudaError_t err = allow_smem(kernel, smem, raised);
  if (err != cudaSuccess) return err;
  kernel<<<pl.grid, kTileWarps * 32, smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const int32_t*>(qw),
      static_cast<const float*>(scales), static_cast<const float*>(zeros),
      static_cast<const int32_t*>(gidx), static_cast<bf16*>(out), part, B, M,
      width, G, gs, span_seq, pl.per);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_f32_tile(const Plan& pl, const void* x, const void* qw,
                            const void* scales, const void* zeros,
                            const void* gidx, void* out, float* part, int B,
                            int M, int width, int G, int gs, cudaStream_t s) {
  const auto kernel = uniform_f32_tile<BITS>;
  const size_t smem = sizeof(float) * 2 * kF32K * kF32Ld;
  static bool raised = false;
  const cudaError_t err = allow_smem(kernel, smem, raised);
  if (err != cudaSuccess) return err;
  kernel<<<pl.grid, 256, smem, s>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(qw),
      static_cast<const float*>(scales), static_cast<const float*>(zeros),
      static_cast<const int32_t*>(gidx), static_cast<float*>(out), part, B, M,
      width, G, gs, pl.per);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t uniform_paths(const Plan& pl, const void* x, const void* qw,
                          const void* scales, const void* zeros,
                          const void* gidx, void* out, float* part, int B,
                          int M, int width, int G, int gs, int x_bf16,
                          cudaStream_t s) {
  if (pl.path == kGemv)
    return x_bf16 ? launch_uniform<bf16, BITS, kMaxTB>(
                        x, qw, scales, zeros, gidx, out, B, M, width, G, gs, s)
                  : launch_uniform<float, BITS, kMaxTB>(
                        x, qw, scales, zeros, gidx, out, B, M, width, G, gs, s);
  cudaError_t err;
  if (pl.path == kDecode) {
    const int mode =
        !gidx && gs % kDecChunk == 0 && width % kDecChunk == 0 ? 0 : 1;
    uniform_tc_decode<BITS><<<pl.grid, pl.nt * 32, pl.smem, s>>>(
        static_cast<const bf16*>(x), static_cast<const int32_t*>(qw),
        static_cast<const float*>(scales), static_cast<const float*>(zeros),
        static_cast<const int32_t*>(gidx), static_cast<bf16*>(out), part, B,
        M, width, G, gs, mode, pl.per);
    err = cudaGetLastError();
  } else if (pl.path == kTileF32) {
    err = launch_f32_tile<BITS>(pl, x, qw, scales, zeros, gidx, out, part, B,
                                M, width, G, gs, s);
  } else {
    const int span_seq = !gidx && gs % 16 == 0;
    err = pl.nt == 4
              ? launch_tc_tile<BITS, 4>(pl, x, qw, scales, zeros, gidx, out,
                                        part, B, M, width, G, gs, span_seq, s)
              : launch_tc_tile<BITS, 8>(pl, x, qw, scales, zeros, gidx, out,
                                        part, B, M, width, G, gs, span_seq, s);
  }
  if (err != cudaSuccess) return err;
  return sum_splits(pl, part, B, M, nullptr, out, x_bf16, s);
}

template <int BITS, int NT>
cudaError_t launch_a8_tile(const Plan& pl, const void* x8, const void* sx,
                           const void* sumx, const void* qw,
                           const void* scales, const void* zeros, void* out,
                           int out_bf16, float* part, int B, int M, int width,
                           int G, int gs, int zside, cudaStream_t s) {
  const auto kernel = uniform_a8_tc_tile<BITS, NT>;
  const size_t smem = (size_t)kA8Stages * 8 * NT * kA8Row +
                      sizeof(uint32_t) * 2 * kTileRows * kA8WordRow;
  static bool raised = false;
  const cudaError_t err = allow_smem(kernel, smem, raised);
  if (err != cudaSuccess) return err;
  kernel<<<pl.grid, kTileWarps * 32, smem, s>>>(
      static_cast<const int8_t*>(x8), static_cast<const float*>(sx),
      static_cast<const int32_t*>(sumx), static_cast<const int32_t*>(qw),
      static_cast<const float*>(scales), static_cast<const float*>(zeros), out,
      out_bf16, part, B, M, width, G, gs, zside, pl.per);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t a8_paths(const Plan& pl, const void* x8, const void* sx,
                     const void* sumx, const void* qw, const void* scales,
                     const void* zeros, void* out, float* part, int B, int M,
                     int width, int G, int gs, int x_bf16, cudaStream_t s) {
  if (pl.path == kGemv)
    return x_bf16 ? launch_a8<bf16, BITS, kMaxTB>(x8, sx, sumx, qw, scales,
                                                  zeros, out, B, M, width, G,
                                                  gs, s)
                  : launch_a8<float, BITS, kMaxTB>(x8, sx, sumx, qw, scales,
                                                   zeros, out, B, M, width, G,
                                                   gs, s);
  const int zside = zeros != nullptr || BITS < 8;
  cudaError_t err;
  if (pl.path == kDecode) {
    uniform_a8_tc_decode<BITS><<<pl.grid, pl.nt * 32, pl.smem, s>>>(
        static_cast<const int8_t*>(x8), static_cast<const float*>(sx),
        static_cast<const int32_t*>(sumx), static_cast<const int32_t*>(qw),
        static_cast<const float*>(scales), static_cast<const float*>(zeros),
        out, x_bf16, part, B, M, width, G, gs, zside, pl.per);
    err = cudaGetLastError();
  } else {
    err = pl.nt == 4
              ? launch_a8_tile<BITS, 4>(pl, x8, sx, sumx, qw, scales, zeros,
                                        out, x_bf16, part, B, M, width, G, gs,
                                        zside, s)
              : launch_a8_tile<BITS, 8>(pl, x8, sx, sumx, qw, scales, zeros,
                                        out, x_bf16, part, B, M, width, G, gs,
                                        zside, s);
  }
  if (err != cudaSuccess) return err;
  return sum_splits(pl, part, B, M, static_cast<const float*>(sx), out, x_bf16,
                    s);
}

}  // namespace

// The number of float32 partial sums a call of ganq_uniform_matmul at this
// shape needs in its part buffer (0: K is not split over blocks).
extern "C" int ganq_uniform_matmul_scratch(int B, int M, int width, int bits,
                                           int x_bf16) {
  return scratch_floats(plan_uniform(B, M, width, bits, x_bf16), B, M);
}

// x [B, width * packfactor] (bf16 if x_bf16 else f32), qw [M, width] int32,
// scales [M, G] f32, zeros [M, G] f32 or null (symmetric: the centre
// 2^(bits-1)), gidx [K] int32 or null (sequential: column / gs), out [B, M]
// in x's type, part the scratch that ganq_uniform_matmul_scratch sizes (null
// when it is 0); all contiguous, x and qw 16-byte aligned. Returns the
// cudaError_t of the launches.
extern "C" int ganq_uniform_matmul(const void* x, const void* qw,
                                   const void* scales, const void* zeros,
                                   const void* gidx, void* out, void* part,
                                   int B, int M, int width, int G, int gs,
                                   int bits, int x_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan pl = plan_uniform(B, M, width, bits, x_bf16);
  float* pp = static_cast<float*>(part);
  cudaError_t err;
  switch (bits) {
    case 2: err = uniform_paths<2>(pl, x, qw, scales, zeros, gidx, out, pp, B, M, width, G, gs, x_bf16, s); break;
    case 3: err = uniform_paths<3>(pl, x, qw, scales, zeros, gidx, out, pp, B, M, width, G, gs, x_bf16, s); break;
    case 4: err = uniform_paths<4>(pl, x, qw, scales, zeros, gidx, out, pp, B, M, width, G, gs, x_bf16, s); break;
    case 8: err = uniform_paths<8>(pl, x, qw, scales, zeros, gidx, out, pp, B, M, width, G, gs, x_bf16, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The number of float32 partial sums a call of ganq_uniform_a8_matmul at
// this shape needs in its part buffer (0: K is not split over blocks).
extern "C" int ganq_uniform_a8_matmul_scratch(int B, int M, int width,
                                              int bits) {
  return scratch_floats(plan_a8(B, M, width, bits), B, M);
}

// x [B, K = width * packfactor] (bf16 if x_bf16 else f32); scratch x8
// [B, K] int8, sx [B] f32, sumx [B, G] int32, part as sized by
// ganq_uniform_a8_matmul_scratch (null when 0); qw [M, width] int32, scales
// [M, G] f32, zeros [M, G] f32 or null (symmetric: the centre 2^(bits-1));
// out [B, M] in x's type. Groups are sequential, gs = K / G, and every
// 128-word span of a plane lies inside one group. Two launches (activation
// quantization, then the int8 product) on the stream, and a third that adds
// the partial sums when K is split over blocks.
extern "C" int ganq_uniform_a8_matmul(const void* x, const void* qw,
                                      const void* scales, const void* zeros,
                                      void* x8, void* sx, void* sumx,
                                      void* out, void* part, int B, int M,
                                      int width, int G, int bits, int x_bf16,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pf = 32 / (bits == 3 ? 4 : bits);
  const int K = width * pf;
  const int gs = K / G;
  const Plan pl = plan_a8(B, M, width, bits);
  // the group sums of x8 feed only the zero side, which the tensor-core
  // paths skip for symmetric 8-bit codes (z' = 128 - 128 = 0)
  const bool need_sumx = pl.path == kGemv || zeros || bits < 8;
  cudaError_t err = quant_a8(x, x_bf16, B, K, x8, sx,
                             need_sumx ? sumx : nullptr, G, gs, s);
  if (err != cudaSuccess) return (int)err;
  float* pp = static_cast<float*>(part);
  switch (bits) {
    case 2: err = a8_paths<2>(pl, x8, sx, sumx, qw, scales, zeros, out, pp, B, M, width, G, gs, x_bf16, s); break;
    case 3: err = a8_paths<3>(pl, x8, sx, sumx, qw, scales, zeros, out, pp, B, M, width, G, gs, x_bf16, s); break;
    case 4: err = a8_paths<4>(pl, x8, sx, sumx, qw, scales, zeros, out, pp, B, M, width, G, gs, x_bf16, s); break;
    case 8: err = a8_paths<8>(pl, x8, sx, sumx, qw, scales, zeros, out, pp, B, M, width, G, gs, x_bf16, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
