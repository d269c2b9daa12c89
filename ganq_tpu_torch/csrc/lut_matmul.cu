// LUT-dequant matrix product for Hopper (sm_90a).
//
// Replaces ganq_tpu/ops/lut_matmul.py:lut_matmul (the Pallas kernel
// _lut_matmul_kernel). Computes
//
//     out[b, m] = sum_k x[b, k] * lut[m, code(m, k)]
//
// with one 2^bits-entry codebook per output row m and the codes planar-packed
// in int32 words (ops/packing.py): bit-slot p of word w of row m holds the
// code of column p * width + w. x arrives zero-padded to width * packfactor
// columns, so padding codes add nothing. The codebook is widened to float
// exactly, the sum is taken in float, and the output is rounded to x's type.
// The TPU's arithmetic select tree exists only because the TPU has no
// gather; here the codebook sits in shared memory and a code is one shift,
// one mask and one lookup (the LUT-mpGEMM of the GANQ paper).
//
// Two kernels, chosen by the number of token rows B:
//
// * lut_gemv_kernel (B <= 8 per block row tile; decode, and f32 x). Bound on
//   this card: the packed weight bytes, M * K * bits / 8, over the memory
//   rate (3.35 TB/s on an H100 SXM); the work is a lookup and B FMAs per
//   weight. Each warp owns kRows output rows and its lanes stride over
//   16-byte groups of packed words (coalesced 512-byte rows per warp, kQuads
//   groups per row in flight per lane). The x values of a group's columns
//   are loaded once and reused for all kRows rows and all kPf planes share
//   the word loads, so x costs a fraction of a load per weight. Larger B
//   runs more block rows, each reading the weights again (from L2).
//
// * lut_tc_kernel (bf16 x, B > 8; prefill below the engine's dequant-GEMM
//   switch). There the work is 2 * B * M * K operations and the bound is
//   the tensor cores. A block computes a 64 x 64 tile of out with bf16
//   warp-level MMAs (nvcuda::wmma, float accumulation). Each K step decodes
//   8 packed words of 64 rows (all planes) into a bf16 weight tile in shared
//   memory and loads the matching x columns, so every weight is decoded
//   once per 64 token rows; the next step's global loads are issued into
//   registers before the current step's MMAs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

// four consecutive values as floats; p is aligned to four elements
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const bf16* p, float v[4]) {
  const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(a); v[1] = __high2float(a);
  v[2] = __low2float(b); v[3] = __high2float(b);
}

template <int BITS> struct Codes {
  static constexpr int kSlot = BITS == 3 ? 4 : BITS;   // bits per slot
  static constexpr int kPf = 32 / kSlot;               // codes per word
  static constexpr int kV = 1 << BITS;                 // codebook entries
  static constexpr uint32_t kMask = (1u << BITS) - 1u;
  static __device__ __forceinline__ int at(uint32_t word, int p) {
    return (word >> (kSlot * p)) & kMask;
  }
};

// ------------------------------------------------------------------ GEMV
constexpr int kGemvWarps = 8;   // warps per block
constexpr int kRows = 2;        // output rows per warp
constexpr int kChunkQ = 32;     // 4-word groups per row per K chunk (a lane each)
constexpr int kMaxTB = 8;       // token rows per block row

__device__ __forceinline__ float part(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// one 4-word group of packed codes of each of a warp's rows; rows past M
// repeat row M - 1 (their sums are never stored), words past width are 0
template <int R>
__device__ __forceinline__ void load_words(const int32_t* __restrict__ idx,
                                           int m0, int M, int width, int w,
                                           bool vec, uint32_t (&wd)[R][4]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int32_t* row = idx + (size_t)min(m0 + r, M - 1) * width + w;
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

template <typename XT, typename LT, int BITS, int TB>
__global__ void __launch_bounds__(kGemvWarps * 32)
lut_gemv_kernel(const XT* __restrict__ x, const LT* __restrict__ lut,
                const int32_t* __restrict__ idx, XT* __restrict__ out, int B,
                int M, int width) {
  using C = Codes<BITS>;
  // this chunk's x as float: group [(j * kPf + p) * kChunkQ + lane] holds
  // columns p * width + w0 + 4 * lane .. + 3 of token row j
  extern __shared__ float4 xs[];
  __shared__ float lut_s[kGemvWarps][kRows][C::kV];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = (blockIdx.x * kGemvWarps + warp) * kRows;
  const int b0 = blockIdx.y * TB;
  const int nb = min(TB, B - b0);
  const size_t kp = (size_t)width * C::kPf;   // row length of x
  for (int e = lane; e < kRows * C::kV; e += 32) {
    const int r = e / C::kV, v = e % C::kV;
    lut_s[warp][r][v] =
        m0 + r < M ? to_f(lut[(size_t)(m0 + r) * C::kV + v]) : 0.f;
  }

  float acc[kRows][TB];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < TB; ++j) acc[r][j] = 0.f;

  const bool vec = (width & 3) == 0;   // rows and x planes 16-byte aligned
  constexpr int kChunkWords = 4 * kChunkQ;
  const int nchunk = (width + kChunkWords - 1) / kChunkWords;
  uint32_t wd[kRows][4], wn[kRows][4];
  load_words(idx, m0, M, width, 4 * lane, vec, wd);
  for (int c = 0; c < nchunk; ++c) {
    const int w0 = c * kChunkWords;
    __syncthreads();   // previous chunk's x fully read (and lut_s written)
    for (int e = threadIdx.x; e < TB * C::kPf * kChunkQ;
         e += kGemvWarps * 32) {
      const int g = e % kChunkQ, jp = e / kChunkQ;
      const int p = jp % C::kPf, j = jp / C::kPf;
      const int w = w0 + 4 * g;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (j < nb && w < width) {
        const XT* xp = x + (size_t)(b0 + j) * kp + (size_t)p * width + w;
        if (vec) {
          load4(xp, v);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = w + i < width ? to_f(xp[i]) : 0.f;
        }
      }
      xs[e] = make_float4(v[0], v[1], v[2], v[3]);
    }
    if (c + 1 < nchunk)   // next chunk's codes in flight during this one
      load_words(idx, m0, M, width, w0 + kChunkWords + 4 * lane, vec, wn);
    __syncthreads();
    if (m0 < M && w0 + 4 * lane < width) {
#pragma unroll
      for (int p = 0; p < C::kPf; ++p) {
        float4 xv[TB];
#pragma unroll
        for (int j = 0; j < TB; ++j) xv[j] = xs[(j * C::kPf + p) * kChunkQ + lane];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float wv = lut_s[warp][r][C::at(wd[r][i], p)];
#pragma unroll
            for (int j = 0; j < TB; ++j)
              acc[r][j] = fmaf(part(xv[j], i), wv, acc[r][j]);
          }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) wd[r][i] = wn[r][i];
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

template <typename XT, typename LT, int BITS, int TB>
cudaError_t launch_gemv(const void* x, const void* lut, const void* idx,
                        void* out, int B, int M, int width,
                        cudaStream_t stream) {
  const auto kernel = lut_gemv_kernel<XT, LT, BITS, TB>;
  const size_t smem = sizeof(float4) * TB * Codes<BITS>::kPf * kChunkQ;
  static bool smem_raised = false;   // above 48 KB only once allowed
  if (smem > 48 * 1024 && !smem_raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_raised = true;
  }
  const int rows_per_block = kGemvWarps * kRows;
  const dim3 grid((M + rows_per_block - 1) / rows_per_block,
                  (B + TB - 1) / TB);
  kernel<<<grid, kGemvWarps * 32, smem, stream>>>(
      static_cast<const XT*>(x), static_cast<const LT*>(lut),
      static_cast<const int32_t*>(idx), static_cast<XT*>(out), B, M, width);
  return cudaSuccess;
}

template <typename XT, typename LT, int BITS>
cudaError_t gemv_bits(const void* x, const void* lut, const void* idx,
                      void* out, int B, int M, int width,
                      cudaStream_t stream) {
  if (B == 1)
    return launch_gemv<XT, LT, BITS, 1>(x, lut, idx, out, B, M, width, stream);
  if (B == 2)
    return launch_gemv<XT, LT, BITS, 2>(x, lut, idx, out, B, M, width, stream);
  if (B <= 4)
    return launch_gemv<XT, LT, BITS, 4>(x, lut, idx, out, B, M, width, stream);
  return launch_gemv<XT, LT, BITS, kMaxTB>(x, lut, idx, out, B, M, width,
                                           stream);
}

// ------------------------------------------------------- tensor-core tile
constexpr int kTileM = 64;      // output features per block
constexpr int kTileB = 64;      // token rows per block
constexpr int kStepW = 8;      // packed words per row per K step
constexpr int kTcThreads = 128; // four warps, each a 32 x 32 sub-tile

template <int BITS> struct TcShape {
  static constexpr int kKc = Codes<BITS>::kPf * kStepW;   // K per step
  static constexpr int kLd = kKc + 8;            // tile pitch (bf16)
  static constexpr int kLdc = kTileM + 4;        // epilogue pitch (float)
  static constexpr int kTileBytes = 2 * kTileM * kLd * 2;
  static constexpr int kEpiBytes = kTileB * kLdc * 4;
  static constexpr int kBytes =
      kTileBytes > kEpiBytes ? kTileBytes : kEpiBytes;
  static constexpr int kXLoads = kTileB * Codes<BITS>::kPf / kTcThreads;
  static constexpr int kWLoads = kTileM * kStepW / kTcThreads;
};

template <int BITS>
__global__ void __launch_bounds__(kTcThreads)
lut_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ lut,
              const int32_t* __restrict__ idx, bf16* __restrict__ out, int B,
              int M, int width) {
  using namespace nvcuda;
  using C = Codes<BITS>;
  using S = TcShape<BITS>;
  __shared__ __align__(128) unsigned char smem[S::kBytes];
  __shared__ bf16 lut_s[kTileM][C::kV];
  bf16* xs = reinterpret_cast<bf16*>(smem);          // [kTileB][kLd]
  bf16* ws = xs + kTileB * S::kLd;                    // [kTileM][kLd]
  float* cs = reinterpret_cast<float*>(smem);         // [kTileB][kLdc]

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kTileM;
  const int b0 = blockIdx.y * kTileB;
  const size_t kp = (size_t)width * C::kPf;
  for (int e = tid; e < kTileM * C::kV; e += kTcThreads) {
    const int r = e / C::kV;
    lut_s[r][e % C::kV] = m0 + r < M ? lut[(size_t)(m0 + r) * C::kV + e % C::kV]
                                     : __float2bfloat16(0.f);
  }

  // this thread's loads per K step: x strips (token row, plane) of 8
  // columns, and single packed words (feature row, word)
  uint4 xr[S::kXLoads];
  uint32_t wr[S::kWLoads];
  auto load_step = [&](int w0) {
#pragma unroll
    for (int s = 0; s < S::kXLoads; ++s) {
      const int e = tid + s * kTcThreads;
      const int bi = e / C::kPf, p = e % C::kPf;
      xr[s] = b0 + bi < B
                  ? __ldg(reinterpret_cast<const uint4*>(
                        x + (size_t)(b0 + bi) * kp + (size_t)p * width + w0))
                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int s = 0; s < S::kWLoads; ++s) {
      const int e = tid + s * kTcThreads;
      const int mi = e / kStepW, i = e % kStepW;
      wr[s] = m0 + mi < M
                  ? (uint32_t)__ldg(idx + (size_t)(m0 + mi) * width + w0 + i)
                  : 0u;
    }
  };

  const int warp = tid >> 5;
  const int wb = (warp >> 1) * 32;   // this warp's token rows in the tile
  const int wm = (warp & 1) * 32;    // and its feature columns
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  load_step(0);
  for (int w0 = 0; w0 < width; w0 += kStepW) {
    __syncthreads();   // previous step's tiles fully read (and lut_s written)
#pragma unroll
    for (int s = 0; s < S::kXLoads; ++s) {
      const int e = tid + s * kTcThreads;
      const int bi = e / C::kPf, p = e % C::kPf;
      *reinterpret_cast<uint4*>(xs + bi * S::kLd + p * kStepW) = xr[s];
    }
#pragma unroll
    for (int s = 0; s < S::kWLoads; ++s) {
      const int e = tid + s * kTcThreads;
      const int mi = e / kStepW, i = e % kStepW;
#pragma unroll
      for (int p = 0; p < C::kPf; ++p)
        ws[mi * S::kLd + p * kStepW + i] = lut_s[mi][C::at(wr[s], p)];
    }
    __syncthreads();
    if (w0 + kStepW < width) load_step(w0 + kStepW);   // in flight below
#pragma unroll
    for (int kk = 0; kk < S::kKc; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], xs + (wb + 16 * i) * S::kLd + kk, S::kLd);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], ws + (wm + 16 * j) * S::kLd + kk, S::kLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }

  __syncthreads();   // tiles no longer read: reuse their memory for out
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wb + 16 * i) * S::kLdc + wm + 16 * j,
                              acc[i][j], S::kLdc, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < kTileB * kTileM; e += kTcThreads) {
    const int bi = e / kTileM, mi = e % kTileM;
    if (b0 + bi < B && m0 + mi < M)
      out[(size_t)(b0 + bi) * M + m0 + mi] =
          __float2bfloat16(cs[bi * S::kLdc + mi]);
  }
}

template <int BITS>
void launch_tc(const void* x, const void* lut, const void* idx, void* out,
               int B, int M, int width, cudaStream_t stream) {
  const dim3 grid((M + kTileM - 1) / kTileM, (B + kTileB - 1) / kTileB);
  lut_tc_kernel<BITS><<<grid, kTcThreads, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(lut),
      static_cast<const int32_t*>(idx), static_cast<bf16*>(out), B, M, width);
}

template <typename XT, typename LT, int BITS>
cudaError_t launch_one(const void* x, const void* lut, const void* idx,
                       void* out, int B, int M, int width, bool tc,
                       cudaStream_t stream) {
  if (!tc) return gemv_bits<XT, LT, BITS>(x, lut, idx, out, B, M, width, stream);
  launch_tc<BITS>(x, lut, idx, out, B, M, width, stream);
  return cudaSuccess;
}

template <typename XT, typename LT>
int launch_types(const void* x, const void* lut, const void* idx, void* out,
                 int B, int M, int width, int bits, bool tc,
                 cudaStream_t stream) {
  cudaError_t err;
  switch (bits) {
    case 2: err = launch_one<XT, LT, 2>(x, lut, idx, out, B, M, width, tc, stream); break;
    case 3: err = launch_one<XT, LT, 3>(x, lut, idx, out, B, M, width, tc, stream); break;
    case 4: err = launch_one<XT, LT, 4>(x, lut, idx, out, B, M, width, tc, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, width * packfactor] (bf16 if x_bf16 else f32, zero-padded past K),
// lut [M, 2^bits] (bf16 if lut_bf16 else f32), idx [M, width] int32, out
// [B, M] in x's type; all contiguous, 16-byte aligned. Types: (bf16, bf16),
// (f32, bf16), (f32, f32). bf16 x with B > 8 and width % 8 == 0 runs the
// tensor-core tile kernel, everything else the GEMV kernel. Returns the
// cudaError_t of the launch.
extern "C" int ganq_lut_matmul(const void* x, const void* lut, const void* idx,
                               void* out, int B, int M, int width, int bits,
                               int x_bf16, int lut_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tc = x_bf16 && B > kMaxTB && width % kStepW == 0;
  if (x_bf16 && lut_bf16)
    return launch_types<bf16, bf16>(x, lut, idx, out, B, M, width, bits, tc,
                                    s);
  if (!x_bf16 && lut_bf16)
    return launch_types<float, bf16>(x, lut, idx, out, B, M, width, bits,
                                     false, s);
  if (!x_bf16 && !lut_bf16)
    return launch_types<float, float>(x, lut, idx, out, B, M, width, bits,
                                      false, s);
  return (int)cudaErrorInvalidValue;
}
