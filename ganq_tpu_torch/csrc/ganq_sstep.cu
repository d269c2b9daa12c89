// GANQ S-step for Hopper (sm_90a): the two TPU kernels of
// ganq_tpu/ops/ganq_solver.py, s_step_blocked_pallas (the blocked walk the
// solver picks by default) and s_step_pallas (the per-column walk).
//
// Both compute, for W [m, n], L [n, n] lower-triangular and one codebook
// T [m, V] per row (V = 2^bits, 4 .. 256), walking the columns
// j = n-1 .. 0 of every row independently:
//
//     r        = sum_{l > j} Werr[:, l] * L[l, j]
//     eff      = W[:, j] + r / L[j, j]          (IEEE division)
//     Q[:, j]  = argmin_s |eff - T[:, s]|       (first index on a tie)
//     Werr[:, j] = W[:, j] - T[Q[:, j]]
//
// Rows never interact; the walk over columns is a chain of n dependent
// steps per row. The committed-column products are about m * n^2
// floating-point operations, which bound both kernels: 67 TFLOP/s in
// float32 on the CUDA cores of an H100 SXM, or three TF32 passes at 495
// TFLOP/s on the tensor cores. The chain (a division and a V-way minimum
// per column) is kept off the products' path: it walks from registers and
// shared memory, and the products run as tiles over the whole card.
//
// Both entry points take Lt = L^T, row-major ([n, n], row j = column j of
// L): the memory of the column-major Cholesky factor as it comes.
//
// The products run on the tensor cores as 3xTF32 (the analogue of the
// TPU's Precision.HIGHEST): each float32 operand x is split into hi, its
// TF32 rounding, and lo, the TF32 rounding of x - hi; three mma.sync
// m16n8k8 products lo*hi, hi*lo and hi*hi (small terms first) are summed in
// float32 by the tensor core. Only lo*lo and lo's own rounding are lost,
// about 2^-21 of each product.
//
// Kernel 3, blocked (ganq_sstep_blocked; replaces s_step_blocked_pallas).
// Columns go in blocks of 128, right to left (the rightmost block is ragged
// when n is not a multiple of 128). For each block [b0, b1), two launches:
//   * trailing_product: the block's residuals from the committed columns,
//     R = Werr[:, b1:n] @ L[b1:n, b0:b1], split over K into S <= 8 chunks
//     of at least 256 columns (S sized for two blocks an SM), each chunk's
//     partial sum P[s] [m, 128] written on its own; the walk adds them in
//     split order (no atomics: the result does not depend on the schedule).
//     A 128 x 128 tile a block, 8-deep stages double-buffered through
//     shared memory, each warp 32 x 64 of it.
//   * walk_block: one lane per row, 4 warps a block (2 for V > 32). The
//     block's 128 x 128 diagonal tile of Lt is staged once by cp.async; the
//     walk goes in sub-blocks of 8 columns whose W, residuals, corrections
//     and errors live in registers (the in-sub-block corrections are FMAs
//     on registers; the next sub-block's W and partial sums are loaded a
//     sub-block ahead). A finished sub-block pushes its 8 errors onto the
//     corrections of the block's remaining columns (per-lane shared memory,
//     L read as broadcast float4). The codebook sits in registers for V <=
//     32 (a tree minimum: the right half wins only when strictly nearer)
//     and in shared memory for larger V (four interleaved scans merged left
//     to right).
// Summation order of kernel 3's residual: r = (P[0] + P[1] + ... + P[S-1])
// + a, each P[s] the tensor core's float32 sum of its chunk's 8-deep steps
// in ascending k, a the in-block corrections added in descending column
// order (as the plain version adds them), then eff = W + r / L[j, j].
//
// Kernel 4, per column (ganq_sstep_columns; replaces s_step_pallas). The
// Pallas kernel's structure in one launch: one block per 16 rows (an m16
// tile), columns in blocks of 16 right to left. For each column block
// [j0, j1) its residuals over every committed column are one product,
// Werr[rows, j1:n] @ L[j1:n, j0:j1], recomputed from Werr (nothing carried
// from block to block: the per-column function): each of the 8 warps takes
// every 8th 16-deep step (float4 loads of Werr and Lt rows), and the warps'
// sums are added in warp order. Then the block's columns are walked, one
// thread a row (a half-warp a row for V > 32), with the in-block band
// corrections (FMAs on registers, descending column order) from a staged
// 16 x 16 tile of L. Summation order: r = (S_0 + ... + S_7) + a, S_w warp
// w's float32 sum of its 16-deep steps in ascending k.
//
// Rounding: the division is IEEE (no --use_fast_math). FMAs round a product
// and a sum once where the plain PyTorch version rounds twice, 3xTF32
// drops about 2^-21 of each product, and every sum runs in another order
// than the plain version's, so an assignment can flip where two codewords
// are within a few float32 ulps of eff.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlk = 128;          // columns per block of the blocked walk
constexpr int kPM = 128;           // product tile: rows (columns: kBlk)
constexpr int kPK = 8;             // product tile: depth of a stage
constexpr int kPS = kPM + 8;       // shared-memory row stride of a stage
constexpr int kPT = 256;           // product threads
constexpr int kMaxSplit = 8;       // K chunks of a block's product, at most
constexpr int kMinChunk = 256;     // columns of a K chunk, at least
constexpr int kReserve = 100 * 1024;  // shared memory a product block holds
constexpr int kCR = 16;            // rows per block of the column walk
constexpr int kCB = 16;            // columns per block of the column walk
constexpr int kCW = 8;             // warps per block of the column walk

// 16 bytes global -> shared; zero-filled (nothing read) when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(a),
               "l"(src), "r"(ok ? 16 : 0));
}

// x = hi + lo with hi its TF32 rounding and lo the remainder's
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in three TF32 passes, the small terms first
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4],
                                           uint32_t bhi0, uint32_t bhi1,
                                           uint32_t blo0, uint32_t blo1) {
  mma_tf32(d, alo, bhi0, bhi1);
  mma_tf32(d, ahi, blo0, blo1);
  mma_tf32(d, ahi, bhi0, bhi1);
}

// The nearest codeword of one row: q = argmin_s |eff - T[s]|, the first s
// on a tie, and its value.
template <int NV, bool kRegs = (NV <= 32)>
struct Codebook;

// in registers: a tree minimum whose right half wins only when strictly
// nearer, so the first index survives a tie
template <int NV>
struct Codebook<NV, true> {
  float tv[NV];
  __device__ __forceinline__ void load(const float* trow, float*) {
#pragma unroll
    for (int s = 0; s < NV; ++s) tv[s] = __ldg(trow + s);
  }
  __device__ __forceinline__ int nearest(float eff, float& val) const {
    float d[NV], v[NV];
    int ix[NV];
#pragma unroll
    for (int s = 0; s < NV; ++s) {
      d[s] = fabsf(eff - tv[s]);
      v[s] = tv[s];
      ix[s] = s;
    }
#pragma unroll
    for (int h = 1; h < NV; h *= 2)
#pragma unroll
      for (int s = 0; s + h < NV; s += 2 * h)
        if (d[s + h] < d[s]) {
          d[s] = d[s + h];
          v[s] = v[s + h];
          ix[s] = ix[s + h];
        }
    val = v[0];
    return ix[0];
  }
};

// in shared memory, a lane's codewords contiguous (16-byte aligned, rows
// kTsPad floats apart so that a warp's float4 loads do not conflict): four
// scans over contiguous quarters, interleaved, merged left to right
constexpr int kTsPad = 4;
template <int NV>
struct Codebook<NV, false> {
  const float* ts;
  __device__ __forceinline__ void load(const float* trow, float* dst) {
    for (int s = 0; s < NV; s += 4)
      *reinterpret_cast<float4*>(dst + s) =
          __ldg(reinterpret_cast<const float4*>(trow + s));
    ts = dst;
  }
  __device__ __forceinline__ int nearest(float eff, float& val) const {
    constexpr int kC = 4, kLen = NV / kC;
    float bd[kC];
    int bq[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      bd[c] = INFINITY;
      bq[c] = c * kLen;
    }
#pragma unroll 2
    for (int s = 0; s < kLen; s += 4)
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float4 v = *reinterpret_cast<const float4*>(ts + c * kLen + s);
        const float d[4] = {fabsf(eff - v.x), fabsf(eff - v.y),
                            fabsf(eff - v.z), fabsf(eff - v.w)};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (d[e] < bd[c]) {
            bd[c] = d[e];
            bq[c] = c * kLen + s + e;
          }
      }
#pragma unroll
    for (int c = 1; c < kC; ++c)
      if (bd[c] < bd[0]) {
        bd[0] = bd[c];
        bq[0] = bq[c];
      }
    val = ts[bq[0]];
    return bq[0];
  }
};

// ------------------------------------------------------------- kernel 3
// P[s][row][c] = sum_{k in chunk s} Werr[row, k] * Lt[b0 + c, k], c < 128,
// chunk s = [k0 + s * chunk, min(k0 + (s + 1) * chunk, n)), s = blockIdx.y;
// 3xTF32 on mma.sync, each warp a 32 x 64 piece of the 128 x 128 tile
__global__ void __launch_bounds__(kPT)
trailing_product(const float* __restrict__ E, const float* __restrict__ Lt,
                 float* __restrict__ P, int m, int n, int b0, int k0,
                 int chunk) {
  __shared__ __align__(16) float As[2][kPK][kPS];   // As[k][row]
  __shared__ __align__(16) float Bs[2][kPK][kPS];   // Bs[k][col]
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kPM;
  const int kb = k0 + blockIdx.y * chunk, ke = min(kb + chunk, n);
  // loads: 8 consecutive k of 4 rows (of Werr, of Lt) a warp
  const int la_r = tid >> 3, la_k = tid & 7;
  float ra[4], rb[4];
  auto fetch = [&](int k) {
    const int gk = k + la_k;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gr = row0 + la_r + 32 * i;
      ra[i] = (gr < m && gk < ke) ? E[(size_t)gr * n + gk] : 0.f;
      rb[i] = gk < ke ? Lt[(size_t)(b0 + la_r + 32 * i) * n + gk] : 0.f;
    }
  };
  auto put = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      As[buf][la_k][la_r + 32 * i] = ra[i];
      Bs[buf][la_k][la_r + 32 * i] = rb[i];
    }
  };

  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;            // fragment coordinates
  const int wr = warp >> 1, wc = warp & 1;           // rows wr*32, cols wc*64
  float acc[2][8][4] = {};

  fetch(kb);
  put(0);
  __syncthreads();
  int buf = 0;
  for (int k = kb; k < ke; k += kPK) {
    const bool more = k + kPK < ke;
    if (more) fetch(k + kPK);
    uint32_t ahi[2][4], alo[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wr * 32 + mi * 16 + g;
      split_tf32(As[buf][t4][r], ahi[mi][0], alo[mi][0]);
      split_tf32(As[buf][t4][r + 8], ahi[mi][1], alo[mi][1]);
      split_tf32(As[buf][t4 + 4][r], ahi[mi][2], alo[mi][2]);
      split_tf32(As[buf][t4 + 4][r + 8], ahi[mi][3], alo[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int c = wc * 64 + ni * 8 + g;
      uint32_t bh0, bl0, bh1, bl1;
      split_tf32(Bs[buf][t4][c], bh0, bl0);
      split_tf32(Bs[buf][t4 + 4][c], bh1, bl1);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        mma_3xtf32(acc[mi][ni], ahi[mi], alo[mi], bh0, bh1, bl0, bl1);
    }
    if (more) put(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  float* out = P + (size_t)blockIdx.y * m * kBlk;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + wr * 32 + mi * 16 + g + 8 * h;
      if (row >= m) continue;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
        *reinterpret_cast<float2*>(out + (size_t)row * kBlk + wc * 64 + ni * 8 +
                                   2 * t4) =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
    }
}

template <int NV>
struct WalkCfg {
  static constexpr int kWarps = NV > 32 ? 2 : 4;
  static constexpr size_t kSmem =
      sizeof(float) * (kBlk * kBlk + kWarps * kBlk * 32 +
                       (NV > 32 ? kWarps * 32 * (NV + kTsPad) : 0));
};

// One column block [b0, b0 + bw) of the blocked walk; P holds the S
// partial sums of the block's trailing residuals (S = 0: the rightmost
// block, which has none).
template <int NV>
__global__ void __launch_bounds__(WalkCfg<NV>::kWarps * 32)
walk_block(const float* __restrict__ W, const float* __restrict__ Lt,
           const float* __restrict__ T, const float* __restrict__ P, int S,
           float* __restrict__ Werr, int* __restrict__ Q, int m, int n,
           int b0, int bw) {
  constexpr int kWarps = WalkCfg<NV>::kWarps;
  extern __shared__ __align__(16) float smem[];
  float* Ls = smem;                       // Ls[c * kBlk + t] = L[b0+t, b0+c]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* accs = smem + kBlk * kBlk + warp * kBlk * 32 + lane;  // [c * 32]
  const int row = (blockIdx.x * kWarps + warp) * 32 + lane;
  const bool live = row < m;
  const int rr = live ? row : m - 1;

  // the diagonal tile of Lt, its upper triangle (the rest zero)
  if ((n & 3) == 0) {
    for (int i = threadIdx.x; i < kBlk * kBlk / 4; i += blockDim.x) {
      const int c = i >> 5, t = (i & 31) * 4;
      const bool ok = c < bw && t < bw && t + 3 >= c;
      cp_async16(Ls + c * kBlk + t,
                 ok ? Lt + (size_t)(b0 + c) * n + b0 + t : Lt, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    for (int i = threadIdx.x; i < kBlk * kBlk; i += blockDim.x) {
      const int c = i >> 7, t = i & (kBlk - 1);
      Ls[i] = (t < bw && c <= t) ? Lt[(size_t)(b0 + c) * n + b0 + t] : 0.f;
    }
  }
  for (int c = 0; c < kBlk; ++c) accs[c * 32] = 0.f;
  Codebook<NV> cb;
  cb.load(T + (size_t)rr * NV,
          smem + kBlk * kBlk + kWarps * kBlk * 32 +
              (warp * 32 + lane) * (NV + kTsPad));
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  const float* wrow = W + (size_t)rr * n + b0;
  const float* prow = P + (size_t)rr * kBlk;
  const size_t pstride = (size_t)m * kBlk;
  float* erow = Werr + (size_t)rr * n + b0;
  int* qrow = Q + (size_t)rr * n + b0;
  // a sub-block's W and the S partial sums of its trailing residuals,
  // loaded a sub-block ahead into registers (added, in split order, when
  // the sub-block starts: a load consumed at once would stall the chain)
  const bool vec = (n & 3) == 0;          // rows 16-byte aligned
  float wn[8];
  float4 pn[kMaxSplit + 1][2];
  auto fetch = [&](int t0) {
    if (vec && t0 + 8 <= bw) {
      const float4 x0 = __ldg(reinterpret_cast<const float4*>(wrow + t0));
      const float4 x1 = __ldg(reinterpret_cast<const float4*>(wrow + t0 + 4));
      wn[0] = x0.x; wn[1] = x0.y; wn[2] = x0.z; wn[3] = x0.w;
      wn[4] = x1.x; wn[5] = x1.y; wn[6] = x1.z; wn[7] = x1.w;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        wn[i] = t0 + i < bw ? __ldg(wrow + t0 + i) : 0.f;
    }
#pragma unroll
    for (int s = 0; s <= kMaxSplit; ++s)
      if (s < S) {
        const float* p = prow + s * pstride + t0;
        pn[s][0] = __ldg(reinterpret_cast<const float4*>(p));
        pn[s][1] = __ldg(reinterpret_cast<const float4*>(p + 4));
      }
  };

  const int nsb = (bw + 7) >> 3;
  fetch((nsb - 1) * 8);
  for (int sb = nsb - 1; sb >= 0; --sb) {
    const int t0 = sb * 8;
    float w[8], r[8], a[8], werr[8];
    int q[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      w[i] = wn[i];
      r[i] = 0.f;
      a[i] = accs[(t0 + i) * 32];
    }
#pragma unroll
    for (int s = 0; s <= kMaxSplit; ++s)
      if (s < S) {
        r[0] += pn[s][0].x; r[1] += pn[s][0].y;
        r[2] += pn[s][0].z; r[3] += pn[s][0].w;
        r[4] += pn[s][1].x; r[5] += pn[s][1].y;
        r[6] += pn[s][1].z; r[7] += pn[s][1].w;
      }
    if (sb > 0) fetch(t0 - 8);
#pragma unroll
    for (int i = 7; i >= 0; --i) {
      const int t = t0 + i;
      werr[i] = 0.f;
      q[i] = 0;
      if (t < bw) {
        const float eff = w[i] + (r[i] + a[i]) / Ls[t * kBlk + t];
        float val;
        q[i] = cb.nearest(eff, val);
        werr[i] = w[i] - val;
#pragma unroll
        for (int i2 = 0; i2 < i; ++i2)
          a[i2] = fmaf(werr[i], Ls[(t0 + i2) * kBlk + t], a[i2]);
      }
    }
    if (live && vec && t0 + 8 <= bw) {
      *reinterpret_cast<float4*>(erow + t0) =
          make_float4(werr[0], werr[1], werr[2], werr[3]);
      *reinterpret_cast<float4*>(erow + t0 + 4) =
          make_float4(werr[4], werr[5], werr[6], werr[7]);
      *reinterpret_cast<int4*>(qrow + t0) = make_int4(q[0], q[1], q[2], q[3]);
      *reinterpret_cast<int4*>(qrow + t0 + 4) =
          make_int4(q[4], q[5], q[6], q[7]);
    } else if (live) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (t0 + i < bw) {
          erow[t0 + i] = werr[i];
          qrow[t0 + i] = q[i];
        }
    }
    // the sub-block's errors onto the corrections of columns c < t0
    for (int c = 0; c < t0; c += 8) {
      float ac[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) ac[k] = accs[(c + k) * 32];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float* lc = Ls + (c + k) * kBlk + t0;  // L[b0+t0.., b0+c+k]
        const float4 l0 = *reinterpret_cast<const float4*>(lc);
        const float4 l1 = *reinterpret_cast<const float4*>(lc + 4);
        float v = ac[k];
        v = fmaf(werr[7], l1.w, v);
        v = fmaf(werr[6], l1.z, v);
        v = fmaf(werr[5], l1.y, v);
        v = fmaf(werr[4], l1.x, v);
        v = fmaf(werr[3], l0.w, v);
        v = fmaf(werr[2], l0.z, v);
        v = fmaf(werr[1], l0.y, v);
        ac[k] = fmaf(werr[0], l0.x, v);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) accs[(c + k) * 32] = ac[k];
    }
  }
}

// ------------------------------------------------------------- kernel 4
// One block per 16 rows; columns in blocks of 16, right to left. Werr is
// written and read back here (plain loads: no read-only cache). The walk
// takes G threads a row: for V > 32 a half-warp, each thread V / 16
// codewords in registers, the minimum then exchanged by shuffles (the
// group's threads walk the same row redundantly; its first one stores).
template <int NV>
__global__ void __launch_bounds__(kCW * 32)
walk_columns(const float* __restrict__ W, const float* __restrict__ Lt,
             const float* __restrict__ T, float* Werr, int* __restrict__ Q,
             int m, int n) {
  constexpr int G = NV > 32 ? 16 : 1, NL = NV / G;
  __shared__ float red[kCW][kCR][kCB + 1];
  __shared__ float Rs[kCR][kCB + 1];
  __shared__ float band[kCB][kCB + 1];      // band[t][c] = L[j0+t, j0+c]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int row0 = blockIdx.x * kCR;
  const float* ea = Werr + (size_t)min(row0 + g, m - 1) * n;
  const float* eb = Werr + (size_t)min(row0 + g + 8, m - 1) * n;
  const bool vec = (n & 3) == 0;            // rows 16-byte aligned
  const int wr = tid / G, u = tid % G;      // the walk: row wr, group lane u
  const bool walks = wr < kCR;
  const int row = row0 + wr;
  const bool writes = walks && row < m && u == 0;
  const int rr = min(row, m - 1);
  Codebook<NL> cb;
  if (walks) cb.load(T + (size_t)rr * NV + u * NL, nullptr);

  const int nblk = (n + kCB - 1) / kCB;
  for (int bi = nblk - 1; bi >= 0; --bi) {
    const int j0 = bi * kCB, j1 = min(j0 + kCB, n), bw = j1 - j0;
    {
      const int t = tid >> 4, c = tid & 15;
      band[t][c] = (t < bw && c <= t)
                       ? __ldg(Lt + (size_t)(j0 + c) * n + j0 + t) : 0.f;
    }
    // 16 columns of k a step: thread t4 loads k + 4 t4 .. + 3 of its rows
    // (one float4), so the two 8-deep mma steps take the k of each group of
    // four threads in another order than the fragments' (the same for A
    // and B: the sum is over the same 16 products)
    float acc[2][4] = {};
    for (int k = j1 + 16 * warp; k < n; k += 16 * kCW) {
      const int kk = k + 4 * t4;
      const float* lt0 = Lt + (size_t)(j0 + g) * n;
      const float* lt1 = Lt + (size_t)(j0 + 8 + g) * n;
      float xa[4], xb[4], xl[2][4];
      if (vec && k + 16 <= n) {
        const float4 va = *reinterpret_cast<const float4*>(ea + kk);
        const float4 vb = *reinterpret_cast<const float4*>(eb + kk);
        const float4 v0 = __ldg(reinterpret_cast<const float4*>(lt0 + kk));
        const float4 v1 = __ldg(reinterpret_cast<const float4*>(lt1 + kk));
        xa[0] = va.x; xa[1] = va.y; xa[2] = va.z; xa[3] = va.w;
        xb[0] = vb.x; xb[1] = vb.y; xb[2] = vb.z; xb[3] = vb.w;
        xl[0][0] = v0.x; xl[0][1] = v0.y; xl[0][2] = v0.z; xl[0][3] = v0.w;
        xl[1][0] = v1.x; xl[1][1] = v1.y; xl[1][2] = v1.z; xl[1][3] = v1.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = kk + e < n;
          xa[e] = ok ? ea[kk + e] : 0.f;
          xb[e] = ok ? eb[kk + e] : 0.f;
          xl[0][e] = ok ? __ldg(lt0 + kk + e) : 0.f;
          xl[1][e] = ok ? __ldg(lt1 + kk + e) : 0.f;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t ahi[4], alo[4];
        split_tf32(xa[2 * h], ahi[0], alo[0]);
        split_tf32(xb[2 * h], ahi[1], alo[1]);
        split_tf32(xa[2 * h + 1], ahi[2], alo[2]);
        split_tf32(xb[2 * h + 1], ahi[3], alo[3]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(xl[nt][2 * h], bh0, bl0);
          split_tf32(xl[nt][2 * h + 1], bh1, bl1);
          mma_3xtf32(acc[nt], ahi, alo, bh0, bh1, bl0, bl1);
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      red[warp][g][nt * 8 + 2 * t4] = acc[nt][0];
      red[warp][g][nt * 8 + 2 * t4 + 1] = acc[nt][1];
      red[warp][g + 8][nt * 8 + 2 * t4] = acc[nt][2];
      red[warp][g + 8][nt * 8 + 2 * t4 + 1] = acc[nt][3];
    }
    __syncthreads();
    {
      const int r = tid >> 4, c = tid & 15;
      float s = red[0][r][c];
#pragma unroll
      for (int w = 1; w < kCW; ++w) s += red[w][r][c];
      Rs[r][c] = s;
    }
    __syncthreads();
    if (walks) {
      const float* wrow = W + (size_t)rr * n + j0;
      float* erow = Werr + (size_t)rr * n + j0;
      int* qrow = Q + (size_t)rr * n + j0;
      float wv[kCB], a[kCB];
#pragma unroll
      for (int t = 0; t < kCB; ++t) {
        wv[t] = t < bw ? __ldg(wrow + t) : 0.f;
        a[t] = 0.f;
      }
#pragma unroll
      for (int t = kCB - 1; t >= 0; --t) {
        if (t < bw) {
          const float eff = wv[t] + (Rs[wr][t] + a[t]) / band[t][t];
          float val;
          int q = u * NL + cb.nearest(eff, val);
          if (G > 1) {
            // the group's minimum; the first index on a tie
            float d = fabsf(eff - val);
#pragma unroll
            for (int o = G / 2; o > 0; o >>= 1) {
              const float od = __shfl_xor_sync(0xffffffffu, d, o, G);
              const int oq = __shfl_xor_sync(0xffffffffu, q, o, G);
              const float ov = __shfl_xor_sync(0xffffffffu, val, o, G);
              if (od < d || (od == d && oq < q)) {
                d = od;
                q = oq;
                val = ov;
              }
            }
          }
          const float werr = wv[t] - val;
          if (writes) {
            erow[t] = werr;
            qrow[t] = q;
          }
#pragma unroll
          for (int c = 0; c < t; ++c) a[c] = fmaf(werr, band[t][c], a[c]);
        }
      }
    }
    __syncthreads();
  }
}

int sm_count() {
  static int sms = 0;
  if (sms <= 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        sms <= 0)
      sms = 132;
  }
  return sms;
}

// Kernel 3's two schedules, by shape only. Serial: each block's product,
// then its walk, on the caller's stream. Overlapped: the product of block
// c is split in two, near(c) from block c + 1's columns and far(c) from
// the columns past it; far(c) is known once blocks >= c + 2 are walked, so
// it runs on a second stream while block c + 1 is walked, and near(c) runs
// between the two walks. The overlap pays where the walks take about as
// long as the products (the walk's time grows with n, the products' with
// m n^2): from 8 blocks up to m n = 2^25 (Llama-3.2-1B's linears; its down
// projection 7.7 -> 5.7 ms), not at Llama-3.1-8B's down projection (25.8 ->
// 28.9 ms, its products on fewer SMs) nor at a few blocks.
bool overlapped(int m, int n) {
  return (n + kBlk - 1) / kBlk >= 8 && (long long)m * n <= (1LL << 25);
}

// K chunks a product may take. Serial: about two blocks an SM. Overlapped:
// the far product's blocks and the walk's (walk_rows rows each) fill the
// SMs side by side, one block an SM; a product block then reserves
// kReserve bytes of shared memory that it does not use, so that no walk
// block is placed beside it (a walk sharing its SM with a product ran
// 1.75x slower).
int split_cap(int m, int walk_rows, bool overlap) {
  const int mt = (m + kPM - 1) / kPM, walks = (m + walk_rows - 1) / walk_rows;
  const int blocks = overlap ? sm_count() - walks : 2 * sm_count();
  return max(1, min(kMaxSplit, blocks / mt));
}

// the chunks of a product over K columns
void plan_split(int K, int cap, int& S, int& chunk) {
  S = max(1, min(cap, (K + kMinChunk - 1) / kMinChunk));
  chunk = ((K + S - 1) / S + kPK - 1) / kPK * kPK;
  S = (K + chunk - 1) / chunk;
}

// floats of the partial sums of one block's product (overlapped: its far
// product's and its near product's, the last)
size_t part_floats(int m, int n) {
  const bool ov = overlapped(m, n);
  return (size_t)(split_cap(m, kBlk, ov) + ov) * m * kBlk;
}

// A second stream for the far products, and the events that order it
// against the caller's (made once; the walks stay on the caller's stream)
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t walked[2], far[2];
};

cudaError_t side_stream(Side*& out) {
  static Side side;
  static bool made = false;
  if (!made) {
    cudaError_t err =
        cudaStreamCreateWithFlags(&side.stream, cudaStreamNonBlocking);
    for (int i = 0; i < 2 && err == cudaSuccess; ++i) {
      err = cudaEventCreateWithFlags(&side.walked[i], cudaEventDisableTiming);
      if (err == cudaSuccess)
        err = cudaEventCreateWithFlags(&side.far[i], cudaEventDisableTiming);
    }
    if (err != cudaSuccess) return err;
    made = true;
  }
  out = &side;
  return cudaSuccess;
}

template <int NV>
cudaError_t blocked(const float* w, const float* l, const float* t, float* e,
                    int* q, float* p, int m, int n, cudaStream_t s) {
  using Cfg = WalkCfg<NV>;
  static bool raised = false;     // the shared-memory opt-ins, once
  if (!raised) {
    cudaError_t err = cudaFuncSetAttribute(
        walk_block<NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Cfg::kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(trailing_product,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kReserve);
    if (err != cudaSuccess) return err;
    raised = true;
  }
  const bool ov = overlapped(m, n);
  Side* side = nullptr;
  cudaError_t err = ov ? side_stream(side) : cudaSuccess;
  if (err != cudaSuccess) return err;
  const int rows = Cfg::kWarps * 32;
  const int cap = split_cap(m, rows, ov);
  const int nb = (n + kBlk - 1) / kBlk;
  const int mt = (m + kPM - 1) / kPM;
  // partial sums by block parity: far(c)'s S, then near(c)'s
  float* part[2] = {p, p + part_floats(m, n)};
  const size_t one = (size_t)m * kBlk;
  for (int bi = nb - 1; bi >= 0; --bi) {
    const int b0 = bi * kBlk, b1 = min(b0 + kBlk, n);
    float* pb = part[ov ? bi & 1 : 0];
    int S = 0, chunk;
    if (!ov && b1 < n) {                            // the whole product
      plan_split(n - b1, cap, S, chunk);
      trailing_product<<<dim3(mt, S), kPT, 0, s>>>(e, l, pb, m, n, b0, b1,
                                                   chunk);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    const bool has_far = ov && b1 + kBlk < n;
    if (has_far) plan_split(n - b1 - kBlk, cap, S, chunk);
    if (ov && b1 < n) {                             // near(bi)
      trailing_product<<<dim3(mt, 1), kPT, kReserve, s>>>(
          e, l, pb + S * one, m, n, b0, b1, min(b1 + kBlk, n) - b1);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    if (has_far &&                                  // far(bi), made earlier
        (err = cudaStreamWaitEvent(s, side->far[bi & 1], 0)) != cudaSuccess)
      return err;
    if (ov && b1 < n) ++S;
    walk_block<NV><<<(m + rows - 1) / rows, rows, Cfg::kSmem, s>>>(
        w, l, t, pb, S, e, q, m, n, b0, b1 - b0);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if (ov && bi >= 2) {                            // far(bi - 2)
      const int c = bi - 2;
      plan_split(n - b0, cap, S, chunk);
      if ((err = cudaEventRecord(side->walked[bi & 1], s)) != cudaSuccess ||
          (err = cudaStreamWaitEvent(side->stream, side->walked[bi & 1], 0)) !=
              cudaSuccess)
        return err;
      trailing_product<<<dim3(mt, S), kPT, kReserve, side->stream>>>(
          e, l, part[c & 1], m, n, c * kBlk, b0, chunk);
      if ((err = cudaGetLastError()) != cudaSuccess ||
          (err = cudaEventRecord(side->far[c & 1], side->stream)) !=
              cudaSuccess)
        return err;
    }
  }
  return cudaSuccess;
}

template <int NV>
cudaError_t columns(const float* w, const float* l, const float* t, float* e,
                    int* q, int m, int n, cudaStream_t s) {
  walk_columns<NV><<<(m + kCR - 1) / kCR, kCW * 32, 0, s>>>(w, l, t, e, q, m,
                                                            n);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch the blocked S-step takes: the partial sums of one
// column block's product (serial), or of two blocks' (overlapped).
extern "C" int ganq_sstep_blocked_scratch(int m, int n) {
  return (int)((overlapped(m, n) ? 2 : 1) * part_floats(m, n));
}

// Blocked S-step. Lt is L transposed ([n, n], row j = column j of L: the
// column-major factor's own memory), Werr and Q are [m, n]; P is scratch as
// ganq_sstep_blocked_scratch sizes it. Returns the first CUDA error of the
// launches (0 when all were accepted).
extern "C" int ganq_sstep_blocked(const void* W, const void* Lt, const void* T,
                                  void* Werr, void* Q, void* P, int m, int n,
                                  int V, void* stream) {
  const auto* w = static_cast<const float*>(W);
  const auto* l = static_cast<const float*>(Lt);
  const auto* t = static_cast<const float*>(T);
  auto* e = static_cast<float*>(Werr);
  auto* q = static_cast<int*>(Q);
  auto* p = static_cast<float*>(P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  switch (V) {
    case 4: return (int)blocked<4>(w, l, t, e, q, p, m, n, s);
    case 8: return (int)blocked<8>(w, l, t, e, q, p, m, n, s);
    case 16: return (int)blocked<16>(w, l, t, e, q, p, m, n, s);
    case 32: return (int)blocked<32>(w, l, t, e, q, p, m, n, s);
    case 64: return (int)blocked<64>(w, l, t, e, q, p, m, n, s);
    case 128: return (int)blocked<128>(w, l, t, e, q, p, m, n, s);
    case 256: return (int)blocked<256>(w, l, t, e, q, p, m, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Per-column S-step, one launch; Lt as for the blocked one.
extern "C" int ganq_sstep_columns(const void* W, const void* Lt, const void* T,
                                  void* Werr, void* Q, int m, int n, int V,
                                  void* stream) {
  const auto* w = static_cast<const float*>(W);
  const auto* l = static_cast<const float*>(Lt);
  const auto* t = static_cast<const float*>(T);
  auto* e = static_cast<float*>(Werr);
  auto* q = static_cast<int*>(Q);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  switch (V) {
    case 4: return (int)columns<4>(w, l, t, e, q, m, n, s);
    case 8: return (int)columns<8>(w, l, t, e, q, m, n, s);
    case 16: return (int)columns<16>(w, l, t, e, q, m, n, s);
    case 32: return (int)columns<32>(w, l, t, e, q, m, n, s);
    case 64: return (int)columns<64>(w, l, t, e, q, m, n, s);
    case 128: return (int)columns<128>(w, l, t, e, q, m, n, s);
    case 256: return (int)columns<256>(w, l, t, e, q, m, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
