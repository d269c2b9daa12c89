// LUT-dequant matrix product for Hopper (sm_90a).
//
// Replaces ganq_tpu/ops/lut_matmul.py:lut_matmul (the Pallas kernel
// _lut_matmul_kernel, pallas_call at :129). Computes
//
//     out[b, m] = sum_k x[b, k] * lut[m, code(m, k)]
//
// with one 2^bits-entry codebook per output row m and the codes planar-packed
// in int32 words as the checkpoint stores them (ops/packing.py, read as
// stored): bit-slot p of word w of row m holds the code of column p * width
// + w. x arrives zero-padded to width * packfactor columns, so padding codes
// add nothing. The sum is taken in float and the output is rounded to x's
// type (bf16 x takes a bf16 codebook, exact). The TPU's arithmetic select
// tree exists only because the TPU has no gather; here a codebook value is a
// shared-memory lookup (the LUT-mpGEMM of the GANQ paper).
//
// Bounds on an H100 SXM. Bytes: the packed codes, M * K' * bits / 8, plus
// x, the codebooks and the output, over 3.35 TB/s: at decode batch 4 bits
// stream ~29 weights an SM-cycle, a budget of ~4.4 lane instructions a
// weight. Operations: 2 * B * M * K' over 989 TFLOP/s (bf16 tensor cores).
//
// The lookup is the design's centre. At decode batch a row's pair table
// holds, for every pair of codes (a, b), the two bf16 codebook values
// lut[a] | lut[b] << 16: one 32-bit mma.sync fragment register in one
// shared-memory load. Two neighbouring words w, w + 1 of a row are
// interleaved (interleave: a shift and a masked merge for each of the even
// and odd planes), so that field i of the result indexes the pair of plane
// 2i or 2i + 1 of the two words: 256 entries at 4 bits, 128 at 3 (4-bit
// slots, codes below 8), 16 at 2 (four 2-bit codes a byte, indexed by
// nibble). The pair stands for columns p * width + w and + w + 1, which lie
// next to each other in x: within each 16-word span the mma's k order is
// plane-major and, inside a plane, the words' own, so lane t's fragment
// registers pair words 2t, 2t + 1 and 8 + 2t, 9 + 2t, and x, staged as it
// is stored, gives the matching fragments. The products are exact; only
// the float order of the sums moves. A pair table takes 1 KB a row at 4
// bits, which a prefill tile of hundreds of rows cannot hold beside its
// x: there each row keeps its 16-entry codebook (32 bytes) and a register
// is two 16-bit lookups and a byte permute, used for 8 or 16 products.

// The C entry chooses a path by shape before the launch:
//
// 1. Decode, bf16 x, width a multiple of 16, up to 8 token rows, and up to
//    kDecRows (16) where it splits no K (lut_tc_decode). A warp owns 8
//    output rows, the N side of mma.sync m16n8k16; token rows g and g + 8
//    are its M side, so a weight costs its lookup and no per-token work. A
//    warp's chunk is kDecWords (64) words of each of its rows (2 KB a
//    warp); a lane (g, t) reads words 2t, 2t + 1 and 8 + 2t, 9 + 2t of row
//    g of each 16-word span: one pair table load feeds b0 and one b1 of
//    each plane, and two 32-bit loads of the staged x (an ldmatrix past 8
//    token rows) the A fragments. A block is up to eight warps, wpt of
//    them along the chunks of a row tile and rt row tiles (the fewest that
//    take the fewest rounds of row groups over the SMs); blocks are
//    persistent, stage their x columns in shared memory once with cp.async
//    and walk row groups; a row tile's warps build each group's pair
//    tables and add their sums in warp order in shared memory, meeting at
//    a named barrier of their own; a warp copies its chunks' codes (and,
//    with a group's first, the tile's codebooks) with cp.async into its own
//    two-stage ring, the next chunk in flight while it computes the
//    current one. An item's sums leave the tensor cores after one chunk
//    (four accumulators, at most 256 columns each), then add in IEEE float.
//    K is split over blocks only where the staged x would not fit beside
//    the tables and rings, and a second launch then adds the float32
//    partial sums in split order.
// 2. Prefill, bf16 x, more rows (17-1023 from the engine), width a multiple
//    of 16: lut_tc_tile, 256 rows x 128 token rows a block (eight warps)
//    or 128 x 64 (four warps) by shape. A warp owns 32 rows
//    (two m16 tiles) and all the block's tokens; codes and x go through a
//    three-stage cp.async ring of 16-word steps (128 columns at 3-4 bits,
//    256 at 2); the warp decodes its A fragments in registers through its
//    rows' staged codebooks and uses each for its 8 or 16 n8 tiles, whose
//    B fragments come by ldmatrix. Large tiles keep the bytes each block
//    reads again through L2 (x for every block row, codes for every block
//    column) low; 64-row tiles with pair tables were measured slower by
//    that traffic (PERF.md). K is split over blocks so that no block sums
//    more than kTcChainCols (2048) columns on the tensor cores (their
//    float32 accumulation over 8192-14336 columns broke one bf16 ulp +
//    1e-6 of the output scale for kernel 7), and further where the tiles
//    would leave more than half the SMs idle; a second launch adds the
//    partial sums in split order.
// 3. The GEMV (lut_gemv_kernel) takes float32 x, at every batch, with its
//    exact float FMAs, bf16 x whose width is no multiple of 16, and 8-bit
//    codes at up to kGemv8Rows token rows. Each
//    warp owns kRows output rows and its lanes stride over 16-byte groups
//    of packed words (kChunkQ groups of a row in flight a chunk); the x
//    values of a group's columns are loaded once and reused for all kRows
//    rows and all planes share the word loads. Larger B runs more block
//    rows, each reading the weights again (from L2).
//
// 8-bit codes (256-entry codebooks, four codes a word) have no pair
// tables: 64K pairs a row would not fit. Up to kGemv8Rows token rows take
// the GEMV, whose warps stage their rows' codebooks as float32 (2 rows x
// 256 entries, 2 KB a warp) and look each code up there; more rows take
// lut_tc_tile at 64 rows x 64 token rows a block (two warps), whose rows'
// bf16 codebooks (32 KB) are staged once and decoded in registers as at
// 2-4 bits, K split to the same kTcChainCols columns a block.

#include "mma_sync.cuh"

namespace {

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

// ----------------------------------------------------------- pair tables
template <int BITS> struct Pairs {
  static constexpr int kPf = Codes<BITS>::kPf;
  static constexpr int kV = Codes<BITS>::kV;
  static constexpr int kField = BITS == 2 ? 4 : 8;   // bits of a pair index
  static constexpr int kLo = BITS == 2 ? 2 : 4;      // word a's code in it
  static constexpr int kTbl = BITS == 4 ? 256 : BITS == 3 ? 128 : 16;
};

// words a, b (columns p * width + w and + w + 1) interleaved: field i of ev
// indexes the pair of codes of plane 2i, field i of od that of plane 2i + 1,
// word a's code in the low bits
template <int BITS>
__device__ __forceinline__ void interleave(uint32_t a, uint32_t b,
                                           uint32_t& ev, uint32_t& od) {
  if constexpr (BITS == 2) {
    ev = (a & 0x33333333u) | ((b << 2) & 0xCCCCCCCCu);
    od = ((a >> 2) & 0x33333333u) | (b & 0xCCCCCCCCu);
  } else {
    ev = (a & 0x0F0F0F0Fu) | ((b << 4) & 0xF0F0F0F0u);
    od = ((a >> 4) & 0x0F0F0F0Fu) | (b & 0xF0F0F0F0u);
  }
}

// the pair index of plane p (a constant where the loop unrolls)
template <int BITS>
__device__ __forceinline__ uint32_t pair_index(uint32_t ev, uint32_t od,
                                               int p) {
  using P = Pairs<BITS>;
  return (((p & 1) ? od : ev) >> (P::kField * (p >> 1))) &
         ((1u << P::kField) - 1u);
}

// The codebooks of rows r0 .. r0 + nrows - 1 into shared memory, [row][code]
// (rows past M repeat row M - 1; their sums are never stored), by the whole
// block: kLutLoads loads a thread issued before any is stored
constexpr int kLutLoads = 8;

template <int BITS>
__device__ __forceinline__ void stage_lut(unsigned short* lut_s,
                                          const bf16* lut, int r0, int nrows,
                                          int M) {
  constexpr int kV = Pairs<BITS>::kV;
  const unsigned short* lu = reinterpret_cast<const unsigned short*>(lut);
  for (int base = 0; base < nrows * kV; base += kLutLoads * blockDim.x) {
    unsigned short v[kLutLoads];
#pragma unroll
    for (int i = 0; i < kLutLoads; ++i) {
      const int e = base + threadIdx.x + i * blockDim.x;
      v[i] = e < nrows * kV
                 ? __ldg(lu + (size_t)min(r0 + e / kV, M - 1) * kV + e % kV)
                 : (unsigned short)0;
    }
#pragma unroll
    for (int i = 0; i < kLutLoads; ++i) {
      const int e = base + threadIdx.x + i * blockDim.x;
      if (e < nrows * kV) lut_s[e] = v[i];
    }
  }
}

// The pair tables of a group of 8 rows: entry e of row r at word e * 8 + r,
// so the four lanes that look up in a row's table use four banks of their
// own (r, r + 8, r + 16 and r + 24, by e's low bits), and a lookup address
// is one shift from the index. build_entry writes entry e of the 8 rows
// from their staged codebooks (lut_rows [8][kV]) with two 16-byte stores.
template <int BITS>
__device__ __forceinline__ void build_entry(uint32_t* grp,
                                            const unsigned short* lut_rows,
                                            int e) {
  using P = Pairs<BITS>;
  const int lo = e & ((1 << P::kLo) - 1) & (P::kV - 1);
  const int hi = (e >> P::kLo) & (P::kV - 1);
  uint32_t v[8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
    v[r] = (uint32_t)lut_rows[r * P::kV + lo] |
           ((uint32_t)lut_rows[r * P::kV + hi] << 16);
  *reinterpret_cast<uint4*>(grp + e * 8) = make_uint4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<uint4*>(grp + e * 8 + 4) =
      make_uint4(v[4], v[5], v[6], v[7]);
}

// the table value of pair index i for the row whose table column is tb
__device__ __forceinline__ uint32_t lookup(const uint32_t* tb, uint32_t i) {
  return tb[i << 3];
}

constexpr int kSMs = 132;

// --------------------------------------------------------------- decode
constexpr int kDecRows = 16;       // token rows of the decode path at most
constexpr int kDecWarps = 8;       // warps of a decode block at most
constexpr int kDecSMWarps = 16;    // decode warps an SM holds
constexpr int kDecRing = 2;        // code stages a warp holds
constexpr int kDecWords = 64;      // words of a row in a warp's chunk
constexpr int kDecSpans = kDecWords / 16;      // 16-word spans of a chunk
constexpr int kDecLanesRow = kDecWords / 4;    // 16-byte copies of a row
constexpr int kDecRowB = 4 * kDecWords + 32;   // bytes of a ring row (the
                                   // pad puts a half warp's four rows in
                                   // distinct banks)
// shared memory of an SM, and a decode block's static shared memory with
// the 1 KB the card reserves a block
constexpr int kDecSmemSM = 227 * 1024;
constexpr int kDecStatic = 6 * 1024;

// bytes of a staged token row of the decode slice: every plane's sw words,
// padded so that the eight rows of an ldmatrix fall in distinct banks
template <int BITS>
__host__ __device__ __forceinline__ int dec_pitch(int sw) {
  return Pairs<BITS>::kPf * sw * 2 + 16;
}

// bytes of a row tile's pair tables and staged codebooks
template <int BITS>
__host__ __device__ __forceinline__ int dec_tile_bytes() {
  return 8 * Pairs<BITS>::kTbl * 4 + (8 * Pairs<BITS>::kV * 2 + 15) / 16 * 16;
}

// The decode kernel. A block holds rt = warps / wpt row tiles of 8 rows (a
// row group) x wpt warps along the chunks of its K split (blockIdx.y).
// Blocks are persistent: block b takes row groups b, b + gridDim.x, ...,
// so it stages its x slice once for all of them. A warp's work is a list of
// items, (group, chunk) in group order, `slots` chunks a group; its items'
// codes come through its own ring of kDecRing stages in shared memory
// (cp.async, the next item in flight while the current one is computed;
// the tile's first warp copies the tile's 8 codebooks with a group's first
// item). A row tile's warps meet at a named barrier of their own to build
// the group's pair tables and to add their sums in warp order in shared
// memory at the group's last item. Within a 16-word span of a plane the k
// order is the words' own: lane t's B registers pair words 2t, 2t + 1 and
// 8 + 2t, 9 + 2t; its A registers (x) are two 32-bit loads of the staged
// slice up to 8 token rows, an ldmatrix beyond (WIDE).
template <int BITS, bool WIDE>
__global__ void __launch_bounds__(kDecWarps * 32)
lut_tc_decode(const bf16* __restrict__ x, const bf16* __restrict__ lut,
              const int32_t* __restrict__ idx, bf16* __restrict__ out,
              float* __restrict__ part, int B, int M, int width, int wpt,
              int cps) {
  using P = Pairs<BITS>;
  extern __shared__ __align__(16) unsigned char dec_s[];
  __shared__ float red[kDecWarps][4][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nwarps = blockDim.x >> 5;
  const int rt = nwarps / wpt, tile = warp / wpt, cl = warp % wpt;
  const int groups = ((M + 7) / 8 + rt - 1) / rt;
  const int nch = (width + kDecWords - 1) / kDecWords;
  const int c0 = blockIdx.y * cps, c1 = min(nch, c0 + cps);
  const int sw = cps * kDecWords;             // staged words of a plane
  const int pitch = dec_pitch<BITS>(sw);
  const int slots = (cps + wpt - 1) / wpt;
  const int mine = (int)blockIdx.x < groups
                       ? (groups - blockIdx.x + gridDim.x - 1) / gridDim.x
                       : 0;
  const int nitems = mine * slots;
  const size_t Kp = (size_t)width * P::kPf;
  // [x slice][per row tile: pair tables, codebooks][rings]
  unsigned char* tiles = dec_s + (size_t)B * pitch;
  uint32_t* tbl =
      reinterpret_cast<uint32_t*>(tiles + tile * dec_tile_bytes<BITS>());
  unsigned short* lut_s =
      reinterpret_cast<unsigned short*>(tbl + 8 * P::kTbl);
  unsigned char* ring = tiles + rt * dec_tile_bytes<BITS>() +
                        warp * kDecRing * 8 * kDecRowB;
  // the tile's warps meet here (barrier 0 is the block's)
  auto tile_sync = [&]() {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + tile), "r"(wpt * 32)
                 : "memory");
  };

  // item i: its tile's first row and its chunk
  auto row0 = [&](int i) {
    return ((int)(blockIdx.x + (i / slots) * gridDim.x) * rt + tile) * 8;
  };
  auto chunk = [&](int i) { return c0 + cl + (i % slots) * wpt; };
  // a warp's copy of a row is 4 kDecWords contiguous bytes; one commit
  // group an item
  auto issue = [&](int i) {
    if (i < nitems) {
      const int m0 = row0(i), c = chunk(i);
      unsigned char* st = ring + (i % kDecRing) * 8 * kDecRowB;
#pragma unroll
      for (int e = lane; e < 8 * kDecLanesRow; e += 32) {
        const int r = e / kDecLanesRow, piece = e % kDecLanesRow;
        const int w = c * kDecWords + 4 * piece;
        const bool ok = m0 < M && c < c1 && w < width;
        cp_async16(st + r * kDecRowB + 16 * piece,
                   idx + (size_t)min(m0 + r, M - 1) * width + (ok ? w : 0),
                   ok);
      }
      if (cl == 0 && i % slots == 0) {   // the group's codebooks
        const unsigned short* lu = reinterpret_cast<const unsigned short*>(lut);
        if constexpr (P::kV == 4) {      // 8 bytes a row
          if (lane < 8)
            cp_async8(lut_s + lane * 4,
                      lu + (size_t)min(m0 + lane, M - 1) * 4, true);
        } else {                         // 16 bytes a piece
          constexpr int kPieces = P::kV / 8;
          if (lane < 8 * kPieces)
            cp_async16(lut_s + lane * 8,
                       lu + (size_t)min(m0 + lane / kPieces, M - 1) * P::kV +
                           (lane % kPieces) * 8,
                       true);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kDecRing - 1; ++i) issue(i);

  // the split's x columns of every plane, zero past the width
  {
    const int pieces = sw / 8;                // 16-byte pieces of a plane
    for (int e = threadIdx.x; e < B * P::kPf * pieces; e += blockDim.x) {
      const int n = e / (P::kPf * pieces), r = e % (P::kPf * pieces);
      const int p = r / pieces, h = r % pieces;
      const int w = c0 * kDecWords + 8 * h;
      const bool ok = w < width;
      cp_async16(dec_s + (size_t)n * pitch + p * sw * 2 + h * 16,
                 x + n * Kp + (size_t)p * width + (ok ? w : 0), ok);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();   // the x slice and the first items
  __syncthreads();

  // four accumulators quarter the chain of dependent products; rows m0 +
  // 2t and + 1 of token g (d[.][0..1]) and of token g + 8 (d[.][2..3])
  float fa[4][4];
  float fs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int k = 0; k < 4; ++k) fa[q][k] = 0.f;
  const bool tok = g < B;
  // up to 8 token rows: token g's 32-bit loads; beyond, this lane's
  // ldmatrix row (token (lane & 7) + 8 ((lane >> 3) & 1), rows past B
  // repeating row B - 1, whose sums are never stored) and its 8-word half
  const unsigned char* xl =
      WIDE ? dec_s +
                 (size_t)min((lane & 7) + ((lane >> 3) & 1) * 8, B - 1) *
                     pitch +
                 (lane >> 4) * 16
           : dec_s + (size_t)(tok ? g : 0) * pitch + 4 * t;
  const uint32_t* tb = tbl + g;                // this lane's row's column
  auto compute = [&](int i, const uint4 (&w)[kDecSpans]) {
    const int c = chunk(i);
    if (c >= c1 || row0(i) >= M) return;   // uniform across the warp
    const int wb = (c - c0) * kDecWords;
    const int nj = (width - c * kDecWords) / 16;   // width % 16 == 0
#pragma unroll
    for (int j = 0; j < kDecSpans; ++j) {
      if (j >= nj) break;
      uint32_t e01, o01, e89, o89;
      interleave<BITS>(w[j].x, w[j].y, e01, o01);
      interleave<BITS>(w[j].z, w[j].w, e89, o89);
      const unsigned char* xj = xl + (wb + 16 * j) * 2;
#pragma unroll
      for (int p = 0; p < P::kPf; ++p) {
        uint32_t a[4];
        if constexpr (WIDE) {
          ldmatrix_x4(a, xj + p * sw * 2);
        } else {
          const uint32_t* xp =
              reinterpret_cast<const uint32_t*>(xj + p * sw * 2);
          a[0] = tok ? xp[0] : 0u;
          a[1] = 0u;
          a[2] = tok ? xp[4] : 0u;
          a[3] = 0u;
        }
        mma_bf16(fa[p & 3], a, lookup(tb, pair_index<BITS>(e01, o01, p)),
                 lookup(tb, pair_index<BITS>(e89, o89, p)));
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      fs[k] += (fa[0][k] + fa[1][k]) + (fa[2][k] + fa[3][k]);
      fa[0][k] = fa[1][k] = fa[2][k] = fa[3][k] = 0.f;
    }
  };
  // at a group's last item: the tile's warps add their sums in warp order,
  // its first warp stores them, every warp starts anew
  auto flush = [&](int i) {
    const int m0 = row0(i);
    float sum[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sum[k] = fs[k];
      fs[k] = 0.f;
    }
    if (wpt > 1) {
#pragma unroll
      for (int k = 0; k < 4; ++k) red[warp][k][lane] = sum[k];
      tile_sync();
      if (cl != 0) return;
      for (int w = 1; w < wpt; ++w)
#pragma unroll
        for (int k = 0; k < 4; ++k) sum[k] += red[warp + w][k][lane];
    }
    if (m0 >= M) return;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int n = g + 8 * (k >> 1), row = m0 + 2 * t + (k & 1);
      if (n >= B || row >= M) continue;
      const size_t o = (size_t)n * M + row;
      if (gridDim.y > 1)
        part[(size_t)blockIdx.y * B * M + o] = sum[k];
      else
        store(out + o, sum[k]);
    }
  };
  for (int i = 0; i < nitems; ++i) {
    cp_async_wait<kDecRing - 2>();
    __syncwarp();   // item i landed; item i - 1's stage is read
    if (i % slots == 0) {   // a new row group: its pair tables
      tile_sync();          // the codebooks landed, the last tables are read
      for (int e = cl * 32 + lane; e < P::kTbl; e += wpt * 32)
        build_entry<BITS>(tbl, lut_s, e);
      tile_sync();
    }
    const unsigned char* st =
        ring + (i % kDecRing) * 8 * kDecRowB + g * kDecRowB + 8 * t;
    uint4 w[kDecSpans];   // words 2t, 2t + 1, 8 + 2t, 9 + 2t of each span
#pragma unroll
    for (int j = 0; j < kDecSpans; ++j) {
      const uint2 lo = *reinterpret_cast<const uint2*>(st + 64 * j);
      const uint2 hi = *reinterpret_cast<const uint2*>(st + 64 * j + 32);
      w[j] = make_uint4(lo.x, lo.y, hi.x, hi.y);
    }
    issue(i + kDecRing - 1);
    compute(i, w);
    if (i % slots == slots - 1) flush(i);
  }
}

// ------------------------------------------------------------------ tile
constexpr int kTcStepW = 16;                 // words of a row a K step takes
constexpr int kTcStages = 3;
constexpr int kTcWPitch = 4 * kTcStepW + 32; // bytes of a staged code row
                                             // (padded: a half warp's four
                                             // rows in distinct banks)
constexpr int kTcChainCols = 2048;           // columns a block sums on the
                                             // tensor cores at most

// bytes of a staged token row of x: every plane's 16 words, padded so that
// the eight rows of an ldmatrix fall in distinct banks
template <int BITS>
__host__ __device__ constexpr int tc_xpitch() {
  return Pairs<BITS>::kPf * 2 * kTcStepW + 16;
}
template <int BITS>
__host__ __device__ constexpr int tc_stage(int wm, int nt) {
  return 32 * wm * kTcWPitch + 8 * nt * tc_xpitch<BITS>();
}
// [codebooks][ring]
template <int BITS>
__host__ __device__ constexpr int tc_smem(int wm, int nt) {
  return 32 * wm * Pairs<BITS>::kV * 2 + kTcStages * tc_stage<BITS>(wm, nt);
}
// K steps a block takes at most (its chain on the tensor cores)
template <int BITS>
__host__ __device__ constexpr int tc_chain() {
  return kTcChainCols / (kTcStepW * Pairs<BITS>::kPf);
}

// two codes of a row through its staged codebook (lr, kV bf16): one
// fragment register, code a in the low half
template <int BITS>
__device__ __forceinline__ uint32_t lut_pair(const unsigned short* lr,
                                             uint32_t a, uint32_t b, int p) {
  using C = Codes<BITS>;
  return __byte_perm(lr[C::at(a, p)], lr[C::at(b, p)], 0x5410);
}

// 32 WM rows x 8 NT token rows a block: warp w takes rows 32 w .. + 31 (two
// m16 tiles, their A fragments decoded in registers, lane t's words 2t, 2t
// + 1 and 8 + 2t, 9 + 2t of each span) and all the tokens (NT n8 tiles,
// their B fragments by ldmatrix, each used for both m16 tiles); the
// block's K split, at most tc_chain steps, walks 16-word steps through a
// kTcStages ring. The rows are many, so each keeps its 2^bits bf16
// codebook (32 bytes at 4 bits) rather than a pair table: a register is
// two 16-bit lookups and a byte permute, used for NT products.
template <int BITS, int WM, int NT>
__global__ void __launch_bounds__(WM * 32)
lut_tc_tile(const bf16* __restrict__ x, const bf16* __restrict__ lut,
            const int32_t* __restrict__ idx, bf16* __restrict__ out,
            float* __restrict__ part, int B, int M, int width,
            int steps_per_split) {
  using P = Pairs<BITS>;
  constexpr int kThreads = WM * 32;
  constexpr int BM = 32 * WM, BN = 8 * NT;
  constexpr int XP = tc_xpitch<BITS>();
  constexpr int kStage = tc_stage<BITS>(WM, NT);
  extern __shared__ __align__(16) unsigned char tc_s[];
  unsigned short* lut_s = reinterpret_cast<unsigned short*>(tc_s);
  unsigned char* ring = tc_s + BM * P::kV * 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mb = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nsteps = width / kTcStepW;
  const int s0 = blockIdx.z * steps_per_split;
  const int ns = max(0, min(nsteps, s0 + steps_per_split) - s0);
  const size_t Kp = (size_t)width * P::kPf;

  auto stage = [&](int i) {
    const int w0 = (s0 + i) * kTcStepW;
    unsigned char* buf = ring + (i % kTcStages) * kStage;
    for (int e = threadIdx.x; e < BM * 4; e += kThreads) {
      const int r = e >> 2, h = e & 3;
      cp_async16(buf + r * kTcWPitch + 16 * h,
                 idx + (size_t)min(mb + r, M - 1) * width + w0 + 4 * h, true);
    }
    for (int e = threadIdx.x; e < BN * P::kPf * 2; e += kThreads) {
      const int n = e / (P::kPf * 2), p = (e >> 1) % P::kPf, h = e & 1;
      const bool ok = n0 + n < B;
      cp_async16(buf + BM * kTcWPitch + n * XP + p * 32 + 16 * h,
                 x + (size_t)(ok ? n0 + n : 0) * Kp + (size_t)p * width + w0 +
                     8 * h,
                 ok);
    }
  };
#pragma unroll
  for (int i = 0; i < kTcStages - 1; ++i) {
    if (i < ns) stage(i);
    cp_async_commit();
  }
  stage_lut<BITS>(lut_s, lut, mb, BM, M);   // while the steps land; the
                                            // first barrier below
                                            // publishes them
  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[m][j][k] = 0.f;

  // this lane's ldmatrix row of an n8 tile pair and its 8-word half
  const int xoff = BM * kTcWPitch +
                   ((lane & 7) + ((lane >> 4) << 3)) * XP +
                   ((lane >> 3) & 1) * 16;
  for (int i = 0; i < ns; ++i) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();   // step i landed; step i - 1's buffer is free
    if (i + kTcStages - 1 < ns) stage(i + kTcStages - 1);
    cp_async_commit();
    const unsigned char* wt = ring + (i % kTcStages) * kStage;
    // codes of rows 32 w + 16 m + g + 8 h: words 2t, 2t + 1 (c[..][0..1])
    // and 8 + 2t, 9 + 2t (c[..][2..3])
    uint32_t c[2][2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned char* wr8 =
            wt + (32 * warp + 16 * m + 8 * h + g) * kTcWPitch + 8 * t;
        const uint2 c01 = *reinterpret_cast<const uint2*>(wr8);
        const uint2 c89 = *reinterpret_cast<const uint2*>(wr8 + 32);
        c[m][h][0] = c01.x; c[m][h][1] = c01.y;
        c[m][h][2] = c89.x; c[m][h][3] = c89.y;
      }
    const unsigned char* xt = wt + xoff;
#pragma unroll
    for (int p = 0; p < P::kPf; ++p) {
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const unsigned short* lr =
              lut_s + (32 * warp + 16 * m + 8 * h + g) * P::kV;
          a[m][h] = lut_pair<BITS>(lr, c[m][h][0], c[m][h][1], p);
          a[m][2 + h] = lut_pair<BITS>(lr, c[m][h][2], c[m][h][3], p);
        }
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, xt + 8 * j * XP + p * 32);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_bf16(acc[m][j], a[m], b[0], b[1]);
          mma_bf16(acc[m][j + 1], a[m], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int row = mb + 32 * warp + 16 * m + g + (k >> 1) * 8;
        const int n = n0 + 8 * j + 2 * t + (k & 1);
        if (row >= M || n >= B) continue;
        const size_t o = (size_t)n * M + row;
        if (gridDim.z > 1)
          part[(size_t)blockIdx.z * B * M + o] = acc[m][j][k];
        else
          store(out + o, acc[m][j][k]);
      }
}

// ------------------------------------------------------------- planning
enum Path { kGemv, kDecode, kTile };

struct Plan {
  Path path = kGemv;
  dim3 grid;
  int threads = 0;
  int smem = 0;      // bytes of dynamic shared memory
  int wpt = 0;       // decode: warps of a row tile
  int per = 0;       // K units a split takes (decode chunks, tile steps)
  int nsplit = 1;
  int wn = 0;        // tile: warps (of 32 rows each)
  int nt = 0;        // tile: n8 tiles of tokens
};

// decode: wpt warps along the chunks of a row tile (all of the split's
// chunks up to 8), rt row tiles a block (of those that fit in eight warps,
// the fewest that take the fewest rounds of row groups: a second round is
// a tail); K is split only where the
// staged slice would not fit beside the tables and the warps' rings, and
// not at all past 8 token rows (the tile is cheaper than a split there).
// Persistent blocks: as many as hold kDecSMWarps warps an SM (fewer where
// shared memory allows fewer), never more than the row groups.
template <int BITS>
bool plan_decode(Plan& pl, int B, int M, int width) {
  if (B > kDecRows || width % 16) return false;
  const int tiles = (M + 7) / 8, nch = (width + kDecWords - 1) / kDecWords;
  for (int n = 1; n <= nch; ++n) {
    const int per = (nch + n - 1) / n;
    const int nsplit = (nch + per - 1) / per;
    const int wpt = min(per, kDecWarps);
    // row tiles a block: the fewest rounds of row groups over the SMs,
    // then the fewest tiles
    int best = 0, rounds = 1 << 30;
    for (int rt = 1; rt <= kDecWarps / wpt; ++rt) {
      const int threads = rt * wpt * 32;
      const int smem = B * dec_pitch<BITS>(per * kDecWords) +
                       rt * dec_tile_bytes<BITS>() +
                       threads / 32 * kDecRing * 8 * kDecRowB;
      if (smem + kDecStatic > kDecSmemSM) break;
      const int per_sm = max(1, min(kDecSMWarps * 32 / threads,
                                    kDecSmemSM / (smem + kDecStatic)));
      const int groups = (tiles + rt - 1) / rt;
      const int r = (groups + per_sm * kSMs - 1) / (per_sm * kSMs);
      if (r < rounds) {
        rounds = r;
        best = rt;
        pl.threads = threads;
        pl.smem = smem;
        pl.grid = dim3(min(groups, per_sm * kSMs), nsplit);
      }
    }
    if (!best) continue;
    if (B > 8 && nsplit > 1) return false;
    pl.path = kDecode;
    pl.per = per;
    pl.nsplit = nsplit;
    pl.wpt = wpt;
    return true;
  }
  return false;
}

// tile: two shapes. 256 rows x 128 token rows a block (eight warps) past
// 64 rows where those tiles, K split to the chain, fill three quarters of
// the SMs (and fit in shared memory: not at 2 bits); else 128 x 64 (four
// warps, two blocks an SM). K is split so that no block sums more than
// tc_chain steps, and further, into as many splits as fill about a wave,
// where the tiles would still leave more than half the SMs idle (at least
// 2 steps a split). Each shape is a heavily unrolled kernel a bit width
// whose build adds to the library's: two more shapes (256 x 64, 128 x
// 128) moved the smoke's linears by -8% to +17% (PERF.md).
template <int BITS>
void plan_tile(Plan& pl, int B, int M, int width) {
  pl.path = kTile;
  const int steps = width / kTcStepW;
  const int chain = (steps + tc_chain<BITS>() - 1) / tc_chain<BITS>();
  const bool large = BITS != 2 && BITS != 8 && B > 64 &&
                     4 * ((M + 255) / 256) * ((B + 127) / 128) * chain >=
                         3 * kSMs;
  pl.wn = BITS == 8 ? 2 : large ? 8 : 4;
  pl.nt = large ? 16 : 8;
  const int nb = (B + 8 * pl.nt - 1) / (8 * pl.nt);
  const int bm = 32 * pl.wn;
  const int blocks = ((M + bm - 1) / bm) * nb;
  int n = 2 * blocks * chain >= kSMs ? chain : kSMs / blocks;
  n = max(chain, min(n, max(1, steps / 2)));
  pl.per = (steps + n - 1) / n;
  pl.nsplit = (steps + pl.per - 1) / pl.per;
  pl.grid = dim3((M + bm - 1) / bm, nb, pl.nsplit);
  pl.threads = 32 * pl.wn;
  pl.smem = tc_smem<BITS>(pl.wn, pl.nt);
}

template <int BITS>
Plan plan_bits(int B, int M, int width, int x_bf16) {
  Plan pl;
  if (!x_bf16 || width % 16 || B <= 0 || M <= 0) return pl;
  if (!plan_decode<BITS>(pl, B, M, width)) plan_tile<BITS>(pl, B, M, width);
  return pl;
}

// 8 bits: the GEMV up to kGemv8Rows token rows, the tile beyond
constexpr int kGemv8Rows = 16;

template <>
Plan plan_bits<8>(int B, int M, int width, int x_bf16) {
  Plan pl;
  if (!x_bf16 || width % 16 || B <= kGemv8Rows || M <= 0) return pl;
  plan_tile<8>(pl, B, M, width);
  return pl;
}

Plan plan_lut(int B, int M, int width, int bits, int x_bf16) {
  switch (bits) {
    case 2: return plan_bits<2>(B, M, width, x_bf16);
    case 3: return plan_bits<3>(B, M, width, x_bf16);
    case 4: return plan_bits<4>(B, M, width, x_bf16);
    case 8: return plan_bits<8>(B, M, width, x_bf16);
    default: return Plan();
  }
}

size_t part_bytes(const Plan& pl, int B, int M) {
  return pl.nsplit > 1 ? (size_t)pl.nsplit * B * M * 4 : 0;
}

// the attribute is raised to the most any call has asked so far
template <typename Kernel>
cudaError_t raise_smem(Kernel kernel, int smem, int& raised) {
  if (smem <= raised) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) raised = smem;
  return err;
}

template <int BITS, int WM, int NT>
cudaError_t launch_tile(const Plan& pl, const bf16* x, const bf16* lut,
                        const int32_t* idx, bf16* out, float* part, int B,
                        int M, int width, cudaStream_t s) {
  static int raised = 48 * 1024;
  const cudaError_t err =
      raise_smem(lut_tc_tile<BITS, WM, NT>, pl.smem, raised);
  if (err != cudaSuccess) return err;
  lut_tc_tile<BITS, WM, NT><<<pl.grid, pl.threads, pl.smem, s>>>(
      x, lut, idx, out, part, B, M, width, pl.per);
  return cudaSuccess;
}

template <int BITS>
cudaError_t launch_tc(const Plan& pl, const void* x, const void* lut,
                      const void* idx, void* out, float* part, int B, int M,
                      int width, cudaStream_t s) {
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* lb = static_cast<const bf16*>(lut);
  const int32_t* ib = static_cast<const int32_t*>(idx);
  bf16* ob = static_cast<bf16*>(out);
  cudaError_t err;
  if constexpr (BITS == 8) {   // the tile alone (plan_bits<8>)
    err = launch_tile<8, 2, 8>(pl, xb, lb, ib, ob, part, B, M, width, s);
  } else if (pl.path == kDecode && B > 8) {
    static int raised = 48 * 1024;
    err = raise_smem(lut_tc_decode<BITS, true>, pl.smem, raised);
    if (err != cudaSuccess) return err;
    lut_tc_decode<BITS, true><<<pl.grid, pl.threads, pl.smem, s>>>(
        xb, lb, ib, ob, part, B, M, width, pl.wpt, pl.per);
  } else if (pl.path == kDecode) {
    static int raised = 48 * 1024;
    err = raise_smem(lut_tc_decode<BITS, false>, pl.smem, raised);
    if (err != cudaSuccess) return err;
    lut_tc_decode<BITS, false><<<pl.grid, pl.threads, pl.smem, s>>>(
        xb, lb, ib, ob, part, B, M, width, pl.wpt, pl.per);
  } else if (pl.wn == 4) {
    err = launch_tile<BITS, 4, 8>(pl, xb, lb, ib, ob, part, B, M, width, s);
  } else if constexpr (BITS != 2) {
    err = launch_tile<BITS, 8, 16>(pl, xb, lb, ib, ob, part, B, M, width, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  err = cudaGetLastError();
  if (err != cudaSuccess || pl.nsplit <= 1) return err;
  return launch_sum_splits(part, pl.nsplit, B, M, nullptr, out, 1, s);
}

template <typename XT, typename LT>
int gemv_types(const void* x, const void* lut, const void* idx, void* out,
               int B, int M, int width, int bits, cudaStream_t stream) {
  cudaError_t err;
  switch (bits) {
    case 2: err = gemv_bits<XT, LT, 2>(x, lut, idx, out, B, M, width, stream); break;
    case 3: err = gemv_bits<XT, LT, 3>(x, lut, idx, out, B, M, width, stream); break;
    case 4: err = gemv_bits<XT, LT, 4>(x, lut, idx, out, B, M, width, stream); break;
    case 8: err = gemv_bits<XT, LT, 8>(x, lut, idx, out, B, M, width, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The bytes of scratch a call of ganq_lut_matmul at this shape needs (the
// float32 partial sums of a K split; 0: none).
extern "C" int ganq_lut_matmul_scratch(int B, int M, int width, int bits,
                                       int x_bf16) {
  return (int)part_bytes(plan_lut(B, M, width, bits, x_bf16), B, M);
}

// x [B, width * packfactor] (bf16 if x_bf16 else f32, zero-padded past K),
// lut [M, 2^bits] (bf16 if lut_bf16 else f32), idx [M, width] int32, out
// [B, M] in x's type, scratch as ganq_lut_matmul_scratch sizes it (null
// when 0); all contiguous, 16-byte aligned. Types: (bf16, bf16), (f32,
// bf16), (f32, f32). Returns the cudaError_t of the launches.
extern "C" int ganq_lut_matmul(const void* x, const void* lut, const void* idx,
                               void* out, void* scratch, int B, int M,
                               int width, int bits, int x_bf16, int lut_bf16,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bits < 2 || (bits > 4 && bits != 8)) return (int)cudaErrorInvalidValue;
  if (x_bf16 && lut_bf16) {
    const Plan pl = plan_lut(B, M, width, bits, 1);
    float* part = static_cast<float*>(scratch);
    if (pl.path != kGemv) {
      switch (bits) {
        case 2: return (int)launch_tc<2>(pl, x, lut, idx, out, part, B, M, width, s);
        case 3: return (int)launch_tc<3>(pl, x, lut, idx, out, part, B, M, width, s);
        case 8: return (int)launch_tc<8>(pl, x, lut, idx, out, part, B, M, width, s);
        default: return (int)launch_tc<4>(pl, x, lut, idx, out, part, B, M, width, s);
      }
    }
    return gemv_types<bf16, bf16>(x, lut, idx, out, B, M, width, bits, s);
  }
  if (!x_bf16 && lut_bf16)
    return gemv_types<float, bf16>(x, lut, idx, out, B, M, width, bits, s);
  if (!x_bf16 && !lut_bf16)
    return gemv_types<float, float>(x, lut, idx, out, B, M, width, bits, s);
  return (int)cudaErrorInvalidValue;
}
