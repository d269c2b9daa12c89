// int8-weight matrix products for Hopper (sm_90a).
//
// Replaces two kernels of ganq_tpu/ops/w8_matmul.py:
//
// * w8_matmul (Pallas kernel _w8_kernel, pallas_call at :86), entry
//   ganq_w8_matmul:
//
//     out[b, m] = sum_k x[b, k] * rnd_x(float(w8[m, k]) * scale[m])
//
//   with rnd_x the rounding to x's type (the TPU kernel casts the
//   dequantized weight to x's type before its dot); sums in float, output
//   in x's type.
//
// * w8a8_matmul (Pallas kernel _w8a8_kernel, pallas_call at :146), entry
//   ganq_w8a8_matmul: per token row sx = max(max|x| * fl(1/127), 1e-12)
//   and x8 = clamp(rint(x / sx), -127, 127) (a8_quant.cuh, the rule of
//   every int8-activation kernel), an exact int32 dot acc = x8 . w8[m],
//   and out[b, m] = (float(acc) * sx[b]) * scale[m], in that order.
//
// x arrives zero-padded to the weight's K' columns. Bounds on an H100 SXM.
// Bytes: the int8 weight, M * K', plus x and the output, over 3.35 TB/s.
// Operations: 2 * B * M * K' over 989 TFLOP/s (bf16 tensor cores, kernel 7)
// or 1979 TOP/s (int8, kernel 8). At decode batch the bytes bind: 3.35 TB/s
// / 132 SMs / ~1.75 GHz is ~14.5 weights an SM-cycle against 128 lane
// instructions an SM-cycle, a budget of ~8.8 instructions a weight.
//
// The C entries choose a path by shape before the launch:
//
// 1. Decode, K' a multiple of 16, up to 8 token rows, and up to kDecRows
//    (16) where it splits no K: kernel 7 with bf16 x and kernel 8
//    (w8_tc_decode). A warp owns 8 output rows,
//    the N side of mma.sync (m16n8k16 bf16 for kernel 7, m16n8k32 s8 for
//    kernel 8); token rows g and g + 8 are its M side, so a weight costs its
//    decode and no per-token work. Lane (g, t) reads 16 contiguous bytes of
//    row g for each 64-column span of a 512-column chunk (4 KB a warp) and
//    feeds them to the B fragments as they are: the
//    k order inside a span is permuted alike for x, which the lane reads at
//    the same columns of its token rows. Kernel 8's dot is exact in any k
//    order; kernel 7's products are exact and only the float order of the
//    sums moves. Kernel 7 forms rnd_bf16(float(w8) * s) exactly: a byte
//    permute puts the code, offset by 128, in the mantissa of 2^23, one add
//    leaves float(w8), one product and half a cvt.rn.bf16x2 round it. A
//    block is eight warps, wpt of them along the chunks of a row tile and
//    8 / wpt tiles; blocks are persistent (two an SM), stage their x (or
//    x8) columns in shared memory once with cp.async and walk row groups;
//    a warp copies its chunks' weights with cp.async (512 contiguous bytes
//    of a row an instruction) into its own two-stage ring in shared memory
//    and reads its fragments from there, the next chunk in flight while it
//    computes the current one; a tile's warps add their sums in warp order
//    in shared memory. K is split over blocks only where the staged x would
//    not fit beside the rings (~144 KB), and a second launch then adds the
//    partial sums (float32 in split order for kernel 7, int32 for kernel 8,
//    which then applies its epilogue). Kernel 8's x8 and sx come from
//    quant_rows_a8_kernel (a8_quant.cuh), and the decode kernel is launched
//    so that it may start while that runs (programmatic dependent launch):
//    it copies its first weights, then waits for the quantization before it
//    stages x8. A decode kernel that quantized x itself was measured slower
//    (PERF.md).
// 2. Prefill, more rows, K' a multiple of 16: tiled GEMMs on mma.sync, each
//    weight read once per block column of token rows, both operands through
//    a four-stage cp.async ring of 64-column steps. Kernel 8
//    (w8a8_tc_tile): a plain s8 x s8 -> s32 GEMM, ldmatrix fragments of both
//    K-major operands, m16n8k32, eight warps; blocks of 128 x 64 (rows x
//    token rows), 128 x 128 or 256 x 128 by shape (plan_w8a8); the epilogue
//    (float(acc) * sx) * s. Kernel
//    7 with bf16 x (w8_tc_tile): int8 weight tiles (half of the bf16 bytes)
//    and bf16 x tiles; a warp owns 32 rows and all the block's tokens,
//    decodes its A fragments in registers (16 contiguous bytes of a row per
//    lane, the k order permuted alike for x, which it reads with 16-byte
//    loads) and uses each for all its token rows: 128 x 64 blocks, and 256 x
//    128 past 256 token rows on 2048 rows or more. K is split over blocks,
//    with a second launch adding the partial sums, where tile_us (a model
//    of L2 bytes, tensor-core rate and waves) finds it cheaper: kernel 8
//    down to 4 steps a split, its sum launch starting during the tile
//    (programmatic dependent launch); kernel 7 down to 8 steps, and always
//    so that no block sums more than kChainSteps (32) steps on the tensor
//    cores, whose float32 accumulation rounds less exactly than an IEEE
//    add: over 8192-14336 columns unsplit it passed one bf16 ulp + 1e-6 of
//    the output scale, as cuBLAS's bf16 GEMM does on the same inputs
//    (scripts/torch_port_w8_error.py). Kernel 7
//    with float32 x from kF32GemvRows + 1 (41) rows (w8_f32_tile): 64 x
//    64 tiles of dequantized weights and x in shared memory on the CUDA
//    cores, each weight used for 64 token rows (the TPU kernel runs
//    Precision.HIGHEST there; TF32 would change the numbers). mma.sync
//    bounds the tiles: their loops alone ran at ~320 TFLOP/s bf16 and ~580
//    TOP/s int8 on an H100; a warpgroup (wgmma) version of kernel 8's tile,
//    both operands read from shared memory without swizzling, was built
//    and measured slower (PERF.md) and not kept.
// 3. The GEMV kernels (w8_gemv_kernel, w8a8_gemv_kernel) take the rest:
//    K' no multiple of 16 (the w8a8 gate admits those at M <= 8 only),
//    kernel 7 with float32 x up to 40 token rows, and kernel 8 on weights
//    of at most 1 MB (L2-resident: k/v at Llama-3.2-1B widths) from 17 to
//    64 token rows, where it beat the tile (PERF.md). A warp owns kRows output
//    rows and its lanes stride over 16-byte groups of a row; a chunk of x
//    (or x8) is staged in shared memory once per block and reused for every
//    row; token rows come in tiles of up to kMaxTB per block row.

#include "mma_sync.cuh"

namespace {

// the measured thresholds of the paths (PERF.md)
constexpr int kDecRows = 16;       // token rows of the decode path at most
constexpr int kDecSMWarps = 16;    // decode warps an SM holds
constexpr int kDecRing = 2;        // decode weight stages a warp holds
constexpr int kF32GemvRows = 40;   // float32 x: the GEMV up to this many rows
constexpr int kA8GemvBytes = 1 << 20;  // kernel 8: weights of at most this
constexpr int kA8GemvRows = 64;        // many bytes take the GEMV to 64 rows
constexpr int kChainSteps = 32;    // kernel 7 tiles: K' steps of 64 columns
                                   // a block sums on the tensor cores

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
// (the activation quantization, quant_rows_a8_kernel, is in a8_quant.cuh)

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

// ------------------------------------------------------ tensor-core paths
constexpr int kSMs = 132;

// the int8 code in byte i of a word whose bytes were XORed with 0x80, as
// an exact float: 0x4B0000xx is 2^23 + w8 + 128
__device__ __forceinline__ float w8f(uint32_t wx, int i) {
  return __uint_as_float(__byte_perm(wx, 0x4B000000u, 0x7440 + i)) -
         8388736.f;
}

// the four codes of a word as two bf16 pairs, each rnd_bf16(float(w8) * s)
__device__ __forceinline__ uint2 w8_bf16x4(uint32_t w, float s) {
  const uint32_t wx = w ^ 0x80808080u;
  return make_uint2(pack_bf16(w8f(wx, 0) * s, w8f(wx, 1) * s),
                    pack_bf16(w8f(wx, 2) * s, w8f(wx, 3) * s));
}

// Programmatic dependent launch: a kernel launched by launch_dependent
// (kernel 8's decode kernel after its quantization, its split sum after
// its tile) may start while the previous kernel runs; it waits here before
// it reads that kernel's output (the decode kernel copies its first
// weights first)
__device__ __forceinline__ void wait_for_prior() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

constexpr int kDecCols = 512;   // columns of a warp's chunk
constexpr int kDecWarps = 8;    // warps of a decode block at most

// shared memory of an SM, and a decode block's static shared memory with
// the 1 KB the card reserves a block
constexpr int kDecSmemSM = 227 * 1024;
constexpr int kDecStatic = 10 * 1024;

// bytes of a staged row of the decode slice: the slice's columns, padded so
// that a quarter warp's reads (two token rows) fall in distinct banks
__host__ __device__ __forceinline__ int dec_pitch(int ncols, bool a8) {
  return a8 ? ncols + 64 : 2 * ncols + 16;
}

// The decode kernel. A8: kernel 8 (x8 staged), else kernel 7 with bf16 x.
// A block holds rt = warps / wpt row tiles of 8 rows (a row group) x wpt
// warps along the chunks of its K split (blockIdx.y). Blocks are
// persistent: block b takes row groups b, b + gridDim.x, ..., so it stages
// its x slice once for all of them. A warp's work is a list of items,
// (group, chunk) in group order, `slots` chunks a group; its items'
// weights come through its own ring of kDecRing stages in shared memory
// (cp.async, the next item in flight while the current one is computed),
// and at a group's last item the group's warps add their sums in warp
// order in shared memory (double-buffered by group, one barrier a group).
template <bool A8>
__global__ void __launch_bounds__(kDecWarps * 32)
w8_tc_decode(const void* __restrict__ xin, const int8_t* __restrict__ w8,
             const float* __restrict__ scale, const float* __restrict__ sx_in,
             void* __restrict__ out, int out_bf16, void* __restrict__ part,
             int B, int M, int Kp, int wpt, int cps) {
  constexpr int kEs = A8 ? 1 : 2;   // bytes of a staged x element
  extern __shared__ __align__(16) unsigned char dec_s[];
  __shared__ int red[2][kDecWarps][4][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nwarps = blockDim.x >> 5;
  const int rt = nwarps / wpt, tile = warp / wpt, cl = warp % wpt;
  const int groups = ((M + 7) / 8 + rt - 1) / rt;
  const int nch = (Kp + kDecCols - 1) / kDecCols;
  const int c0 = blockIdx.y * cps, c1 = min(nch, c0 + cps);
  const int ncols = (c1 - c0) * kDecCols;
  const int pitch = dec_pitch(cps * kDecCols, A8);
  const int slots = (cps + wpt - 1) / wpt;
  const int mine = (int)blockIdx.x < groups
                       ? (groups - blockIdx.x + gridDim.x - 1) / gridDim.x
                       : 0;
  const int nitems = mine * slots;

  // item i: the first row of its tile and its chunk
  auto row0 = [&](int i) {
    return (int)((blockIdx.x + (i / slots) * gridDim.x) * rt + tile) * 8;
  };
  auto chunk = [&](int i) { return c0 + cl + (i % slots) * wpt; };
  // each warp's ring of kDecRing stages of 8 weight rows x 512 bytes in
  // shared memory after the x slice, filled by cp.async (a warp's copy of a
  // row is 512 contiguous bytes), one commit group an item
  constexpr int kRing = kDecRing, kRowB = kDecCols + 64;
  static_assert(kRing >= 2, "the ring needs two stages");
  unsigned char* ring =
      dec_s + (B * pitch + 15) / 16 * 16 + warp * kRing * 8 * kRowB;
  auto issue = [&](int i) {
    if (i < nitems) {
      const int m0 = row0(i), c = chunk(i);
      const int col = c * kDecCols + 16 * lane;
      const bool ok = m0 < M && c < c1 && col < Kp;
      unsigned char* st = ring + (i % kRing) * 8 * kRowB + 16 * lane;
#pragma unroll
      for (int r = 0; r < 8; ++r)
        cp_async16(st + r * kRowB,
                   w8 + (size_t)min(m0 + r, M - 1) * Kp + (ok ? col : 0), ok);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kRing - 1; ++i) issue(i);

  // the split's x (or x8) columns, zero past K'; kernel 8's x8 once its
  // quantization has run
  if constexpr (A8) wait_for_prior();
  {
    const int per_row = ncols * kEs / 16;
    const unsigned char* src = static_cast<const unsigned char*>(xin);
    for (int e = threadIdx.x; e < B * per_row; e += blockDim.x) {
      const int n = e / per_row, h = e % per_row;
      const int col = c0 * kDecCols + h * (16 / kEs);
      const bool ok = col < Kp;
      cp_async16(dec_s + n * pitch + h * 16,
                 src + ((size_t)n * Kp + (ok ? col : 0)) * kEs, ok);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();   // the x slice and the first items
  __syncthreads();

  // two accumulators halve the chain of dependent products; rows m0 + 2t
  // and + 1 of token g (d[.][0..1]) and of token g + 8 (d[.][2..3])
  float fa[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  int ia[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
  const bool tok = g < B, tok8 = g + 8 < B;
  const unsigned char* xr = dec_s + (tok ? g : 0) * pitch;
  const unsigned char* xr8 = dec_s + (tok8 ? g + 8 : 0) * pitch;
  auto compute = [&](int i, const uint4 (&w)[8], float s) {
    const int c = chunk(i);
    if (c >= c1 || row0(i) >= M) return;   // uniform across the warp
    const int off = (c - c0) * kDecCols * kEs;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if constexpr (A8) {
        const int o = off + 64 * j + 16 * t;
        const uint4 xv =
            tok ? *reinterpret_cast<const uint4*>(xr + o) : zero;
        const uint4 xv8 =
            tok8 ? *reinterpret_cast<const uint4*>(xr8 + o) : zero;
        const uint32_t a0[4] = {xv.x, xv8.x, xv.y, xv8.y};
        const uint32_t a1[4] = {xv.z, xv8.z, xv.w, xv8.w};
        mma_s8(ia[j & 1], a0, w[j].x, w[j].y);
        mma_s8(ia[j & 1], a1, w[j].z, w[j].w);
      } else {
        const int o = off + 2 * (64 * j + 16 * t);
        const uint4* xp = reinterpret_cast<const uint4*>(xr + o);
        const uint4* xp8 = reinterpret_cast<const uint4*>(xr8 + o);
        const uint4 x0 = tok ? xp[0] : zero, x1 = tok ? xp[1] : zero;
        const uint4 y0 = tok8 ? xp8[0] : zero, y1 = tok8 ? xp8[1] : zero;
        const uint32_t xw[8] = {x0.x, x0.y, x0.z, x0.w,
                                x1.x, x1.y, x1.z, x1.w};
        const uint32_t yw[8] = {y0.x, y0.y, y0.z, y0.w,
                                y1.x, y1.y, y1.z, y1.w};
        const uint32_t ww[4] = {w[j].x, w[j].y, w[j].z, w[j].w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint2 b = w8_bf16x4(ww[q], s);
          const uint32_t a[4] = {xw[2 * q], yw[2 * q], xw[2 * q + 1],
                                 yw[2 * q + 1]};
          mma_bf16(fa[j & 1], a, b.x, b.y);
        }
      }
    }
  };
  // at a group's last item: the group's warps add their sums in warp
  // order, the group's first warp stores them, every warp starts anew
  auto flush = [&](int i) {
    const int m0 = row0(i), p = (i / slots) & 1;
    int sum[4];   // (token g, g + 8) x (rows m0 + 2t, + 1)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (A8)
        sum[k] = ia[0][k] + ia[1][k];
      else
        sum[k] = __float_as_int(fa[0][k] + fa[1][k]);
      fa[0][k] = fa[1][k] = 0.f;
      ia[0][k] = ia[1][k] = 0;
    }
    if (wpt > 1) {
#pragma unroll
      for (int k = 0; k < 4; ++k) red[p][warp][k][lane] = sum[k];
      __syncthreads();
      if (cl != 0) return;
      for (int w = 1; w < wpt; ++w)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int v = red[p][warp + w][k][lane];
          sum[k] = A8 ? sum[k] + v
                      : __float_as_int(__int_as_float(sum[k]) +
                                       __int_as_float(v));
        }
    }
    if (m0 >= M) return;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int n = g + 8 * (k >> 1), row = m0 + 2 * t + (k & 1);
      if (n >= B || row >= M) continue;
      const size_t o = (size_t)n * M + row;
      if (gridDim.y > 1)
        static_cast<int*>(part)[(size_t)blockIdx.y * B * M + o] = sum[k];
      else if (A8)
        store_out(out, out_bf16, o,
                  ((float)sum[k] * __ldg(sx_in + n)) *
                      __ldg(scale + row));
      else
        store(static_cast<bf16*>(out) + o, __int_as_float(sum[k]));
    }
  };
  for (int i = 0; i < nitems; ++i) {
    cp_async_wait<kRing - 2>();
    __syncwarp();   // item i landed; item i - 1's stage is read
    const unsigned char* st = ring + (i % kRing) * 8 * kRowB + g * kRowB;
    uint4 w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      w[j] = *reinterpret_cast<const uint4*>(st + 64 * j + 16 * t);
    const float s = A8 ? 0.f : __ldg(scale + min(row0(i) + g, M - 1));
    issue(i + kRing - 1);
    compute(i, w, s);
    if (i % slots == slots - 1) flush(i);
  }
}

// kernel 8's int32 partial sums [nsplit][B][M] added, then its epilogue
__global__ void __launch_bounds__(256)
sum_splits_a8_kernel(const int* __restrict__ part, int nsplit, int B, int M,
                     const float* __restrict__ sx,
                     const float* __restrict__ scale, void* __restrict__ out,
                     int out_bf16) {
  wait_for_prior();
  const size_t n = (size_t)B * M;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    int a = part[i];
    for (int s = 1; s < nsplit; ++s) a += part[(size_t)s * n + i];
    store_out(out, out_bf16, i,
              ((float)a * __ldg(sx + i / M)) * __ldg(scale + i % M));
  }
}

constexpr int kTileK = 64;       // K' columns of a ring stage
constexpr int kStages = 4;
constexpr int kA8Pitch = kTileK + 16;      // bytes of a staged int8 row
constexpr int kXPitch = 2 * kTileK + 16;   // bytes of a staged bf16 x row

// a tile block's sums (token n, row m) to the output or, when K is split
// over blocks, to this split's partial sums
template <typename T>
__device__ __forceinline__ void put_tile(T v, int row, int n, int B, int M,
                                         void* out, int out_bf16, T* part,
                                         const float* sx,
                                         const float* scale) {
  if (row >= M || n >= B) return;
  const size_t o = (size_t)n * M + row;
  if (part)
    part[(size_t)blockIdx.z * B * M + o] = v;
  else if (sx)
    store_out(out, out_bf16, o,
              ((float)v * __ldg(sx + n)) * __ldg(scale + row));
  else
    store_out(out, out_bf16, o, (float)v);
}

// kernel 8 tile: WM x WN warps of MT m16 tiles (rows) x NT n8 tiles
// (tokens), a block of 16 MT WM rows x 8 NT WN token rows; the block's K
// split walks 64-column steps through a kStages ring
template <int WM, int WN, int MT, int NT>
__global__ void __launch_bounds__(WM * WN * 32)
w8a8_tc_tile(const int8_t* __restrict__ x8, const float* __restrict__ sx,
             const int8_t* __restrict__ w8, const float* __restrict__ scale,
             void* __restrict__ out, int out_bf16, int* __restrict__ part,
             int B, int M, int Kp, int steps_per_split) {
  constexpr int kThreads = WM * WN * 32;
  constexpr int BM = 16 * MT * WM, BN = 8 * NT * WN;
  constexpr int kStage = (BM + BN) * kA8Pitch;
  extern __shared__ __align__(16) unsigned char ring8[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WM, wn = warp / WM;
  const int mb = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nsteps = (Kp + kTileK - 1) / kTileK;
  const int s0 = blockIdx.z * steps_per_split;
  const int ns = max(0, min(nsteps, s0 + steps_per_split) - s0);

  auto stage = [&](int i) {
    const int k = (s0 + i) * kTileK;
    unsigned char* buf = ring8 + (i % kStages) * kStage;
    for (int e = threadIdx.x; e < (BM + BN) * 4; e += kThreads) {
      const int r = e >> 2, h = e & 3;
      const int kk = k + 16 * h;
      bool ok = kk < Kp;
      const int8_t* src;
      if (r < BM) {
        src = w8 + (size_t)min(mb + r, M - 1) * Kp;
      } else {
        ok = ok && n0 + r - BM < B;
        src = x8 + (size_t)(ok ? n0 + r - BM : 0) * Kp;
      }
      cp_async16(buf + r * kA8Pitch + 16 * h, src + (ok ? kk : 0), ok);
    }
  };
  // a K split's sum launch may start now and wait for this grid
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < ns) stage(i);
    cp_async_commit();
  }

  int acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0;

  for (int i = 0; i < ns; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // step i landed; step i - 1's buffer is free
    if (i + kStages - 1 < ns) stage(i + kStages - 1);
    cp_async_commit();
    const unsigned char* wt = ring8 + (i % kStages) * kStage;
    const unsigned char* xt = wt + BM * kA8Pitch;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        ldmatrix_x4(a[m], wt + (wm * 16 * MT + m * 16 + (lane & 15)) *
                                  kA8Pitch + ks * 32 + (lane >> 4) * 16);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, xt + (wn * 8 * NT + 8 * j + (lane & 7) +
                             ((lane >> 4) << 3)) * kA8Pitch +
                           ks * 32 + ((lane >> 3) & 1) * 16);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_s8(acc[m][j], a[m], b[0], b[1]);
          mma_s8(acc[m][j + 1], a[m], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  int* p = gridDim.z > 1 ? part : nullptr;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        put_tile<int>(acc[m][j][i],
                      mb + wm * 16 * MT + m * 16 + g + (i >> 1) * 8,
                      n0 + wn * 8 * NT + 8 * j + 2 * t + (i & 1), B, M, out,
                      out_bf16, p, sx, scale);
}

// kernel 7 tile, bf16 x: WM warps of 32 rows x 8 NT token rows, a block of
// 32 WM rows x 8 NT token rows, each warp all of the block's tokens. A lane
// decodes the 16 bytes at columns 16t.. of each of its four rows per
// 64-column step: k16 product q takes bytes 4q..4q+3, which stand for k =
// 2t, 2t+1, 8+2t, 9+2t, and the lane reads x at the same 16 columns of its
// token rows.
template <int WM, int NT>
__global__ void __launch_bounds__(WM * 32)
w8_tc_tile(const bf16* __restrict__ x, const int8_t* __restrict__ w8,
           const float* __restrict__ scale, bf16* __restrict__ out,
           float* __restrict__ part, int B, int M, int Kp,
           int steps_per_split) {
  constexpr int kThreads = WM * 32;
  constexpr int BM = 32 * WM, BN = 8 * NT;
  constexpr int kWTile = BM * kTileK;   // rows of 64 bytes
  constexpr int kStage = kWTile + BN * kXPitch;
  extern __shared__ __align__(16) unsigned char ring[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mb = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nsteps = (Kp + kTileK - 1) / kTileK;
  const int s0 = blockIdx.z * steps_per_split;
  const int ns = max(0, min(nsteps, s0 + steps_per_split) - s0);

  auto stage = [&](int i) {
    const int k = (s0 + i) * kTileK;
    unsigned char* buf = ring + (i % kStages) * kStage;
    for (int e = threadIdx.x; e < BM * 4; e += kThreads) {
      const int r = e >> 2, h = e & 3;
      const bool ok = k + 16 * h < Kp;
      cp_async16(buf + r * kTileK + 16 * h,
                 w8 + (size_t)min(mb + r, M - 1) * Kp + (ok ? k + 16 * h : 0),
                 ok);
    }
    for (int e = threadIdx.x; e < BN * 8; e += kThreads) {
      const int n = e >> 3, h = e & 7;
      const bool ok = n0 + n < B && k + 8 * h < Kp;
      cp_async16(buf + kWTile + n * kXPitch + 16 * h,
                 x + (size_t)(ok ? n0 + n : 0) * Kp + (ok ? k + 8 * h : 0), ok);
    }
  };
  float sc[2][2];   // this lane's rows 32 warp + 16 m + g + 8 h
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      sc[m][h] = __ldg(scale + min(mb + warp * 32 + m * 16 + g + 8 * h, M - 1));
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < ns) stage(i);
    cp_async_commit();
  }

  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][j][i] = 0.f;

  for (int i = 0; i < ns; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (i + kStages - 1 < ns) stage(i + kStages - 1);
    cp_async_commit();
    const unsigned char* wt = ring + (i % kStages) * kStage;
    const unsigned char* xt = wt + kWTile;
    uint32_t a[4][2][4];   // [q][m] A fragments
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 wv = *reinterpret_cast<const uint4*>(
            wt + (warp * 32 + m * 16 + g + 8 * h) * kTileK + 16 * t);
        const uint32_t ww[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint2 b = w8_bf16x4(ww[q], sc[m][h]);
          a[q][m][h] = b.x;
          a[q][m][2 + h] = b.y;
        }
      }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const unsigned char* xp = xt + (8 * j + g) * kXPitch + 32 * t;
      const uint4 x0 = *reinterpret_cast<const uint4*>(xp);
      const uint4 x1 = *reinterpret_cast<const uint4*>(xp + 16);
      const uint32_t xw[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int m = 0; m < 2; ++m)
          mma_bf16(acc[m][j], a[q][m], xw[2 * q], xw[2 * q + 1]);
    }
  }
  cp_async_wait<0>();
  float* p = gridDim.z > 1 ? part : nullptr;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        put_tile<float>(acc[m][j][i],
                        mb + warp * 32 + m * 16 + g + (i >> 1) * 8,
                        n0 + 8 * j + 2 * t + (i & 1), B, M, out, 1, p,
                        nullptr, nullptr);
}

// kernel 7 tile, float32 x: 64 rows x 64 token rows a block, 256 threads
// of 4 x 4 outputs, K in units of 128 columns dequantized once into shared
// memory
constexpr int kF32Tile = 64;
constexpr int kF32K = 128;
constexpr int kF32Ld = kF32Tile + 4;   // padded row of the k-major tiles

__global__ void __launch_bounds__(256)
w8_f32_tile(const float* __restrict__ x, const int8_t* __restrict__ w8,
            const float* __restrict__ scale, float* __restrict__ out,
            float* __restrict__ part, int B, int M, int Kp,
            int units_per_split) {
  extern __shared__ __align__(16) float tiles_f32[];
  float* xs = tiles_f32;                   // [kF32K][kF32Ld]: x by column
  float* ws = tiles_f32 + kF32K * kF32Ld;  // [kF32K][kF32Ld]: w by column
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * kF32Tile, n0 = blockIdx.y * kF32Tile;
  const int nunits = (Kp + kF32K - 1) / kF32K;
  const int u0 = blockIdx.z * units_per_split;
  const int u1 = min(nunits, u0 + units_per_split);

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[r][n] = 0.f;

  for (int u = u0; u < u1; ++u) {
    const int k0 = u * kF32K;
    __syncthreads();   // the previous unit's tiles fully read
    for (int e = tid; e < kF32Tile * kF32K / 4; e += 256) {
      const int n = e / (kF32K / 4), q = e % (kF32K / 4);
      const int k = k0 + 4 * q;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n0 + n < B && k < Kp)
        v = __ldg(reinterpret_cast<const float4*>(x + (size_t)(n0 + n) * Kp +
                                                  k));
      xs[(4 * q + 0) * kF32Ld + n] = v.x;
      xs[(4 * q + 1) * kF32Ld + n] = v.y;
      xs[(4 * q + 2) * kF32Ld + n] = v.z;
      xs[(4 * q + 3) * kF32Ld + n] = v.w;
    }
    for (int e = tid; e < kF32Tile * kF32K / 16; e += 256) {
      const int r = e / (kF32K / 16), h = e % (kF32K / 16);
      const int row = min(m0 + r, M - 1), k = k0 + 16 * h;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k < Kp)
        v = __ldg(reinterpret_cast<const uint4*>(w8 + (size_t)row * Kp + k));
      const float s = __ldg(scale + row);
      const uint32_t ww[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 16; ++i)
        ws[(16 * h + i) * kF32Ld + r] =
            (float)byte_at((int)ww[i >> 2], i & 3) * s;
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

// ------------------------------------------------------------- planning
enum Path { kGemv, kDecode, kTile, kTileF32 };

struct Plan {
  Path path = kGemv;
  dim3 grid;
  int threads = 0;
  int smem = 0;      // bytes of dynamic shared memory
  int wpt = 0;       // decode: warps of a row tile
  int per = 0;       // K units a split takes (decode chunks, tile steps)
  int nsplit = 1;
  int nt = 0;        // tiles: the tile shape (kW8Tiles, kA8Tiles)
};

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

// decode: eight warps a block, wpt of them along the chunks of a row tile
// (all of K' up to 8 chunks) and rt = 8 / wpt row tiles; K is split only
// where the staged slice would not fit beside the warps' rings. Persistent
// blocks: as many as hold kDecSMWarps warps an SM (fewer where shared
// memory allows fewer), never more than the row groups.
void plan_decode(Plan& pl, int B, int M, int Kp, bool a8) {
  pl.path = kDecode;
  const int es = a8 ? 1 : 2;
  const int tiles = (M + 7) / 8, nch = (Kp + kDecCols - 1) / kDecCols;
  // the slice's room: the SM's shared memory less the static arrays, the
  // warps' rings and the row pads
  const int room = kDecSmemSM - kDecStatic - 16 * 64 - 16 -
                   kDecWarps * kDecRing * 8 * (kDecCols + 64);
  int n = (B * nch * kDecCols * es + room - 1) / room;
  n = max(1, min(n, nch));
  pl.per = (nch + n - 1) / n;
  pl.nsplit = (nch + pl.per - 1) / pl.per;
  pl.wpt = min(pl.per, kDecWarps);
  const int rt = kDecWarps / pl.wpt;
  const int groups = (tiles + rt - 1) / rt;
  pl.threads = rt * pl.wpt * 32;
  pl.smem = (B * dec_pitch(pl.per * kDecCols, a8) + 15) / 16 * 16 +
            pl.threads / 32 * kDecRing * 8 * (kDecCols + 64);
  const int by_smem = kDecSmemSM / (pl.smem + kDecStatic);
  const int per_sm = max(1, min(kDecSMWarps * 32 / pl.threads, by_smem));
  pl.grid = dim3(min(groups, per_sm * kSMs), pl.nsplit);
}

// the tile shapes: rows and token rows of a block, blocks an SM holds
struct TileCfg {
  int bm, bn, per_sm;
};
// kernel 7: w8_tc_tile<WM, NT> <4, 8>, <8, 16>
constexpr TileCfg kW8Tiles[] = {{128, 64, 3}, {256, 128, 1}};
// kernel 8: w8a8_tc_tile<WM, WN, MT, NT> <4, 2, 2, 4>, <4, 2, 2, 8>,
// <4, 2, 4, 8>
constexpr TileCfg kA8Tiles[] = {{128, 64, 2}, {128, 128, 2}, {256, 128, 1}};

// A tile plan's estimated microseconds on an H100: the larger of the bytes
// its blocks read through L2 (each block its rows' weights and its tokens'
// x over its K range) at ~3.5 TB/s, its products at `ops_per_us`, and its
// waves of blocks, each block at most ~100 GB/s or one SM's share of the
// products; plus, for a K split, its partial sums written and read again
// and the launch that adds them. (Kernels 7 and 8's first tiles moved
// their L2 bytes at 3.0-3.7 TB/s on the Llama-3.2-1B linears at 128-512
// rows; the rates passed in, 400 TFLOP/s bf16 and 600 TOP/s int8, are near
// what mma.sync's loops alone reached there.)
double tile_us(const TileCfg& c, int xb, double ops_per_us, int B, int M,
               int Kp, int split) {
  const double blocks =
      (double)((M + c.bm - 1) / c.bm) * ((B + c.bn - 1) / c.bn) * split;
  const double kb = (double)Kp / split;
  const double bytes = kb * (c.bm + (double)c.bn * xb);   // a block's
  const double ops = 2.0 * c.bm * c.bn * kb;
  const double waves = ceil(blocks / (kSMs * c.per_sm));
  const double each = fmax(bytes / 1e5, ops * kSMs / ops_per_us) *
                      fmin((double)c.per_sm, ceil(blocks / kSMs));
  double us = fmax(fmax(blocks * bytes / 3.5e6, blocks * ops / ops_per_us),
                   each * waves);
  if (split > 1) us += 2.0 * split * B * M * 4 / 3.5e6 + 2.0;
  return us;
}

// tile shape `shape` of `cfgs` and the K split (1, 2, 4 or 8, at least
// `min_per` steps of 64 columns a split) that tile_us finds cheapest; with
// `max_per`, only splits of at most that many steps (16 where no fewer
// give that; one where none does)
template <int N>
void plan_tile(Plan& pl, const TileCfg (&cfgs)[N], int shape, int xb,
               double ops_per_us, int min_per, int max_per, int B, int M,
               int Kp) {
  pl.path = kTile;
  pl.nt = shape;
  const TileCfg& c = cfgs[pl.nt];
  const int steps = (Kp + kTileK - 1) / kTileK;
  double best = 1e30;
  pl.per = steps;
  for (int split = 1; split <= 16; split *= 2) {
    if (split > 1 && steps / split < min_per) break;
    if (max_per && (steps + split - 1) / split > max_per) continue;
    if (split == 16 && best < 1e30) break;
    const double us = tile_us(c, xb, ops_per_us, B, M, Kp, split);
    if (us < best) {
      best = us;
      pl.per = (steps + split - 1) / split;
    }
  }
  pl.nsplit = (steps + pl.per - 1) / pl.per;
  pl.grid = dim3((M + c.bm - 1) / c.bm, (B + c.bn - 1) / c.bn, pl.nsplit);
}

// The decode path up to 8 token rows, and up to kDecRows where it
// splits no K (a split's second launch costs more than the tile there).
bool decode_plan(Plan& pl, int B, int M, int Kp, bool a8) {
  if (B > kDecRows) return false;
  plan_decode(pl, B, M, Kp, a8);
  if (B <= 8 || pl.nsplit == 1) return true;
  pl = Plan();
  return false;
}

// The tile shapes by shape (measured on the Llama-3.2-1B linears,
// scripts/torch_port_uniform_ab.py, PERF.md): kernel 7 128 x 64, and 256 x
// 128 past 256 token rows on 2048 rows or more; kernel 8 128 x 64, 128 x
// 128 for K' >= 8192 up to 256 token rows and on 8192 rows or more past
// them, and 256 x 128 past 256 token rows for K' >= 8192 on 2048 rows or
// more.
Plan plan_w8(int B, int M, int Kp, int x_bf16) {
  Plan pl;
  if (Kp % 16 != 0 || B <= 0 || M <= 0) return pl;
  if (x_bf16 && decode_plan(pl, B, M, Kp, false)) {
    return pl;
  } else if (x_bf16) {
    plan_tile(pl, kW8Tiles, B > 256 && M >= 2048 ? 1 : 0, 2, 4e8, 8,
              kChainSteps, B, M, Kp);
    const TileCfg& c = kW8Tiles[pl.nt];
    pl.threads = c.bm;   // a warp per 32 rows
    pl.smem = kStages * (c.bm * kTileK + c.bn * kXPitch);
  } else if (B > kF32GemvRows) {
    pl.path = kTileF32;
    pl.grid = dim3((M + kF32Tile - 1) / kF32Tile,
                   (B + kF32Tile - 1) / kF32Tile, 1);
    split_k(pl, (Kp + kF32K - 1) / kF32K, 2, 4 * kSMs);
    pl.threads = 256;
    pl.smem = (int)sizeof(float) * 2 * kF32K * kF32Ld;
  }
  return pl;
}

Plan plan_w8a8(int B, int M, int Kp, int x_bf16) {
  Plan pl;
  if (Kp % 16 != 0 || B <= 0 || M <= 0) return pl;
  if (decode_plan(pl, B, M, Kp, true)) return pl;
  if ((size_t)M * Kp <= (size_t)kA8GemvBytes && B <= kA8GemvRows) return pl;
  const int shape = B <= 256 ? (Kp >= 8192 ? 1 : 0)
                    : Kp >= 8192 && M >= 2048 ? 2 : M >= 8192 ? 1 : 0;
  plan_tile(pl, kA8Tiles, shape, 1, 6e8, 4, 0, B, M, Kp);
  const TileCfg& c = kA8Tiles[pl.nt];
  pl.threads = 256;
  pl.smem = kStages * (c.bm + c.bn) * kA8Pitch;
  return pl;
}

size_t align16(size_t n) { return (n + 15) / 16 * 16; }

size_t part_bytes(const Plan& pl, int B, int M) {
  return pl.nsplit > 1 ? (size_t)pl.nsplit * B * M * 4 : 0;
}

// kernel 8's scratch: x8 and sx, then the partial sums of a K split
size_t a8_scratch(const Plan& pl, int B, int M, int Kp) {
  return align16((size_t)B * Kp) + align16(4 * B) + part_bytes(pl, B, M);
}

// a launch that may start while the stream's previous kernel still runs:
// the kernel waits for it in wait_for_prior
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid,
                             int threads, int smem, cudaStream_t s,
                             Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

cudaError_t sum_a8(const Plan& pl, const int* part, int B, int M,
                   const float* sx, const float* scale, void* out,
                   int out_bf16, cudaStream_t s) {
  const size_t n = (size_t)B * M;
  const int blocks = (int)min((n + 255) / 256, (size_t)4096);
  return launch_dependent(sum_splits_a8_kernel, dim3(blocks), 256, 0, s,
                          part, pl.nsplit, B, M, sx, scale, out, out_bf16);
}

template <bool A8>
cudaError_t launch_decode(const Plan& pl, const void* x, const void* w8,
                          const void* scale, const float* sx, void* out,
                          int out_bf16, void* part, int B, int M, int Kp,
                          cudaStream_t s) {
  const auto kernel = w8_tc_decode<A8>;
  // the attribute is raised to the most any call has asked so far
  static int raised = 48 * 1024;
  if (pl.smem > raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (err != cudaSuccess) return err;
    raised = pl.smem;
  }
  const int8_t* w = static_cast<const int8_t*>(w8);
  const float* sc = static_cast<const float*>(scale);
  if constexpr (A8)
    return launch_dependent(kernel, pl.grid, pl.threads, pl.smem, s, x, w,
                            sc, sx, out, out_bf16, part, B, M, Kp, pl.wpt,
                            pl.per);
  kernel<<<pl.grid, pl.threads, pl.smem, s>>>(x, w, sc, sx, out, out_bf16,
                                              part, B, M, Kp, pl.wpt, pl.per);
  return cudaGetLastError();
}

template <int WM, int WN, int MT, int NT>
cudaError_t launch_a8_tile(const Plan& pl, const int8_t* x8, const float* sx,
                           const void* w8, const void* scale, void* out,
                           int out_bf16, int* part, int B, int M, int Kp,
                           cudaStream_t s) {
  const auto kernel = w8a8_tc_tile<WM, WN, MT, NT>;
  static bool raised = false;
  const cudaError_t err = allow_smem(kernel, pl.smem, raised);
  if (err != cudaSuccess) return err;
  kernel<<<pl.grid, pl.threads, pl.smem, s>>>(
      x8, sx, static_cast<const int8_t*>(w8), static_cast<const float*>(scale),
      out, out_bf16, part, B, M, Kp, pl.per);
  return cudaGetLastError();
}

cudaError_t a8_tile(const Plan& pl, const int8_t* x8, const float* sx,
                    const void* w8, const void* scale, void* out, int out_bf16,
                    int* part, int B, int M, int Kp, cudaStream_t s) {
  switch (pl.nt) {
    case 0:
      return launch_a8_tile<4, 2, 2, 4>(pl, x8, sx, w8, scale, out, out_bf16,
                                        part, B, M, Kp, s);
    case 1:
      return launch_a8_tile<4, 2, 2, 8>(pl, x8, sx, w8, scale, out, out_bf16,
                                        part, B, M, Kp, s);
    default:
      return launch_a8_tile<4, 2, 4, 8>(pl, x8, sx, w8, scale, out, out_bf16,
                                        part, B, M, Kp, s);
  }
}

template <int WM, int NT>
cudaError_t launch_w8_tile(const Plan& pl, const void* x, const void* w8,
                           const void* scale, void* out, float* part, int B,
                           int M, int Kp, cudaStream_t s) {
  const auto kernel = w8_tc_tile<WM, NT>;
  static bool raised = false;
  const cudaError_t err = allow_smem(kernel, pl.smem, raised);
  if (err != cudaSuccess) return err;
  kernel<<<pl.grid, pl.threads, pl.smem, s>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(w8),
      static_cast<const float*>(scale), static_cast<bf16*>(out), part, B, M,
      Kp, pl.per);
  return cudaGetLastError();
}

cudaError_t w8_tile(const Plan& pl, const void* x, const void* w8,
                    const void* scale, void* out, float* part, int B, int M,
                    int Kp, cudaStream_t s) {
  return pl.nt == 0
             ? launch_w8_tile<4, 8>(pl, x, w8, scale, out, part, B, M, Kp, s)
             : launch_w8_tile<8, 16>(pl, x, w8, scale, out, part, B, M, Kp, s);
}

cudaError_t launch_f32_tile(const Plan& pl, const void* x, const void* w8,
                            const void* scale, void* out, float* part, int B,
                            int M, int Kp, cudaStream_t s) {
  static bool raised = false;
  const cudaError_t err = allow_smem(w8_f32_tile, pl.smem, raised);
  if (err != cudaSuccess) return err;
  w8_f32_tile<<<pl.grid, pl.threads, pl.smem, s>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w8),
      static_cast<const float*>(scale), static_cast<float*>(out), part, B, M,
      Kp, pl.per);
  return cudaGetLastError();
}

}  // namespace

// The bytes of scratch a call of ganq_w8_matmul at this shape needs (the
// float32 partial sums of a K split; 0: none).
extern "C" int ganq_w8_matmul_scratch(int B, int M, int Kp, int x_bf16) {
  return (int)part_bytes(plan_w8(B, M, Kp, x_bf16), B, M);
}

// x [B, Kp] (bf16 if x_bf16 else f32), w8 [M, Kp] int8, scale [M] f32, out
// [B, M] in x's type, scratch as ganq_w8_matmul_scratch sizes it (null when
// 0); all contiguous, x and w8 16-byte aligned. Returns the cudaError_t of
// the launches.
extern "C" int ganq_w8_matmul(const void* x, const void* w8, const void* scale,
                              void* out, void* scratch, int B, int M, int Kp,
                              int x_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan pl = plan_w8(B, M, Kp, x_bf16);
  float* part = static_cast<float*>(scratch);
  cudaError_t err;
  switch (pl.path) {
    case kGemv:
      if (x_bf16)
        w8_tiles<bf16>(x, w8, scale, out, B, M, Kp, s);
      else
        w8_tiles<float>(x, w8, scale, out, B, M, Kp, s);
      return (int)cudaGetLastError();
    case kDecode:
      err = launch_decode<false>(pl, x, w8, scale, nullptr, out, 1, part, B,
                                 M, Kp, s);
      break;
    case kTile:
      err = w8_tile(pl, x, w8, scale, out, part, B, M, Kp, s);
      break;
    default:
      err = launch_f32_tile(pl, x, w8, scale, out, part, B, M, Kp, s);
  }
  if (err != cudaSuccess || pl.nsplit <= 1) return (int)err;
  return (int)launch_sum_splits(part, pl.nsplit, B, M, nullptr, out, x_bf16,
                                s);
}

// The bytes of scratch a call of ganq_w8a8_matmul at this shape needs: x8,
// sx and the int32 partial sums of a K split.
extern "C" int ganq_w8a8_matmul_scratch(int B, int M, int Kp, int x_bf16) {
  return (int)a8_scratch(plan_w8a8(B, M, Kp, x_bf16), B, M, Kp);
}

// x [B, Kp] (bf16 if x_bf16 else f32); w8 [M, Kp] int8, scale [M] f32, out
// [B, M] in x's type; scratch as ganq_w8a8_matmul_scratch sizes it. A first
// launch writes x8 [B, Kp] and sx [B] into the scratch (the decode path's
// launch may start during it); where K is split, a last launch adds the
// partial sums.
extern "C" int ganq_w8a8_matmul(const void* x, const void* w8,
                                const void* scale, void* scratch, void* out,
                                int B, int M, int Kp, int x_bf16,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan pl = plan_w8a8(B, M, Kp, x_bf16);
  unsigned char* sp = static_cast<unsigned char*>(scratch);
  int8_t* x8 = reinterpret_cast<int8_t*>(sp);
  float* sx = reinterpret_cast<float*>(sp + align16((size_t)B * Kp));
  sp += align16((size_t)B * Kp) + align16(4 * B);
  cudaError_t err = quant_a8(x, x_bf16, B, Kp, x8, sx, nullptr, 0, 0, s);
  if (err != cudaSuccess) return (int)err;
  int* part = pl.nsplit > 1 ? reinterpret_cast<int*>(sp) : nullptr;
  switch (pl.path) {
    case kGemv:
      if (x_bf16)
        w8a8_tiles<bf16>(x8, sx, w8, scale, out, B, M, Kp, s);
      else
        w8a8_tiles<float>(x8, sx, w8, scale, out, B, M, Kp, s);
      return (int)cudaGetLastError();
    case kDecode:
      err = launch_decode<true>(pl, x8, w8, scale, sx, out, x_bf16, part, B,
                                M, Kp, s);
      break;
    default:
      err = a8_tile(pl, x8, sx, w8, scale, out, x_bf16, part, B, M, Kp, s);
  }
  if (err != cudaSuccess || pl.nsplit <= 1) return (int)err;
  return (int)sum_a8(pl, part, B, M, sx, static_cast<const float*>(scale),
                     out, x_bf16, s);
}
