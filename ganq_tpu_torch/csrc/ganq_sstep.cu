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
// Rows never interact, so the parallelism is over rows; the walk over
// columns is a chain of n dependent steps per row. The committed-column
// products are about m * n^2 floating-point operations in float32 (no tensor
// cores: 67 TFLOP/s on an H100 SXM), which bounds both kernels; the chain
// is what keeps them from that bound (one thread or one warp per row).
//
// Kernel 3, blocked (ganq_sstep_blocked; replaces s_step_blocked_pallas).
// Columns go in blocks of 128, right to left (the last block is ragged
// when n is not a multiple of 128). For each block [b0, b1):
//   * trailing_product: R[:, b0:b1] = Werr[:, b1:n] @ L[b1:n, b0:b1], a
//     tiled float32 FMA product (64 x 32 output tile per block, 4 x 4 per
//     thread) over the committed columns, written transposed for the walk;
//   * walk_block: one thread per row walks the block's columns. The block's
//     W slab, the outputs and the in-block corrections acc[c] live in
//     shared memory (one column of 32 rows per bank row), the row's codebook
//     too; after each column, acc[c] += werr * L[j, b0 + c] for c < t, with
//     the L row read once per warp (all lanes read the same address).
// The Pallas kernel accumulates R in VMEM across a sequential grid; on
// Hopper blocks run in parallel in no order, so the entry point launches a
// product kernel and a walk kernel per column block on the caller's stream.
//
// Kernel 4, per column (ganq_sstep_columns; replaces s_step_pallas). One
// warp per row walks all n columns; at column j the lanes stride over the
// committed columns l > j, reading the row's errors and row j of L^T (both
// contiguous), and a butterfly shuffle sums the dot product and then picks
// the nearest codeword (lanes hold codewords lane, lane + 32, ...; the
// (distance, index) minimum keeps the first index on a tie).
//
// Rounding: the division is IEEE (no --use_fast_math). The products and
// the in-block corrections are fused multiply-adds (one rounding where the
// plain PyTorch version rounds a product and a sum), and every sum runs in
// another order than the plain version's, so an assignment can flip where
// two codewords are within a few float32 ulps of eff.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlk = 128;          // columns per block of the blocked walk
constexpr int kPm = 64, kPn = 32, kPk = 16;   // product tile: rows, cols, depth
constexpr int kPt = 128;           // product threads: a 4 x 4 tile each
constexpr int kWr = 32;            // rows (threads) per walk block
constexpr int kCw = 4;             // rows (warps) per block of the column walk

// Rt[c * m + row] = sum_{l = k0}^{n-1} Werr[row, l] * L[l, b0 + c], c < bw
__global__ void __launch_bounds__(kPt)
trailing_product(const float* __restrict__ Werr, const float* __restrict__ L,
                 float* __restrict__ Rt, int m, int n, int b0, int bw, int k0) {
  __shared__ float As[kPk][kPm + 4];    // As[k][row]
  __shared__ float Bs[kPk][kPn];        // Bs[k][col]
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kPm, col0 = blockIdx.y * kPn;
  const int tr = (tid / 8) * 4, tc = (tid % 8) * 4;
  float acc[4][4] = {};
  for (int k = k0; k < n; k += kPk) {
    for (int i = tid; i < kPm * kPk; i += kPt) {
      const int r = i / kPk, kk = i % kPk;
      const int gr = row0 + r, gk = k + kk;
      As[kk][r] = (gr < m && gk < n) ? Werr[(size_t)gr * n + gk] : 0.f;
    }
    for (int i = tid; i < kPk * kPn; i += kPt) {
      const int kk = i / kPn, c = i % kPn;
      const int gk = k + kk, gc = col0 + c;
      Bs[kk][c] = (gk < n && gc < bw) ? L[(size_t)gk * n + b0 + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kPk; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[kk][tr + i];
        b[i] = Bs[kk][tc + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = row0 + tr + i, col = col0 + tc + c;
      if (row < m && col < bw) Rt[(size_t)col * m + row] = acc[i][c];
    }
}

size_t walk_smem_bytes(int V) {
  return sizeof(float) * (2 * kBlk * (kWr + 1) + kBlk * kWr + V * kWr);
}

// One column block [b0, b0 + bw) of the blocked walk; Rt (null for the
// rightmost block) holds the trailing residual of every column of the block.
__global__ void __launch_bounds__(kWr)
walk_block(const float* __restrict__ W, const float* __restrict__ L,
           const float* __restrict__ T, const float* __restrict__ Rt,
           float* __restrict__ Werr, int* __restrict__ Q, int m, int n, int V,
           int b0, int bw) {
  extern __shared__ float smem[];
  float* ws = smem;                               // [bw][kWr + 1]: W, then werr
  int* qs = reinterpret_cast<int*>(ws + kBlk * (kWr + 1));   // [bw][kWr + 1]
  float* acc = reinterpret_cast<float*>(qs + kBlk * (kWr + 1));  // [bw][kWr]
  float* ts = acc + kBlk * kWr;                   // [V][kWr]
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kWr;
  const int rows = min(kWr, m - row0);

  for (int r = 0; r < rows; ++r)
    for (int c = tid; c < bw; c += kWr)
      ws[c * (kWr + 1) + r] = W[(size_t)(row0 + r) * n + b0 + c];
  for (int i = tid; i < rows * V; i += kWr)
    ts[(i % V) * kWr + i / V] = T[(size_t)(row0 + i / V) * V + i % V];
  for (int c = 0; c < bw; ++c) acc[c * kWr + tid] = 0.f;
  __syncthreads();

  if (tid < rows) {
    const int row = row0 + tid;
    for (int t = bw - 1; t >= 0; --t) {
      const int j = b0 + t;
      const float rext = Rt != nullptr ? Rt[(size_t)t * m + row] : 0.f;
      const float r = rext + acc[t * kWr + tid];
      const float w = ws[t * (kWr + 1) + tid];
      const float eff = w + r / __ldg(L + (size_t)j * n + j);
      float best = fabsf(eff - ts[tid]);
      int q = 0;
      for (int s = 1; s < V; ++s) {
        const float d = fabsf(eff - ts[s * kWr + tid]);
        if (d < best) {
          best = d;
          q = s;
        }
      }
      const float werr = w - ts[q * kWr + tid];
      ws[t * (kWr + 1) + tid] = werr;
      qs[t * (kWr + 1) + tid] = q;
      const float* lrow = L + (size_t)j * n + b0;
#pragma unroll 4
      for (int c = 0; c < t; ++c)
        acc[c * kWr + tid] = fmaf(werr, __ldg(lrow + c), acc[c * kWr + tid]);
    }
  }
  __syncthreads();

  for (int r = 0; r < rows; ++r)
    for (int c = tid; c < bw; c += kWr) {
      const size_t o = (size_t)(row0 + r) * n + b0 + c;
      Werr[o] = ws[c * (kWr + 1) + r];
      Q[o] = qs[c * (kWr + 1) + r];
    }
}

// The per-column walk: one warp per row, Lt = L^T (row j of Lt is column j
// of L, contiguous).
__global__ void __launch_bounds__(kCw * 32)
walk_columns(const float* __restrict__ W, const float* __restrict__ Lt,
             const float* __restrict__ T, float* Werr, int* __restrict__ Q,
             int m, int n, int V) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kCw + (threadIdx.x >> 5);
  if (row >= m) return;
  const float* wrow = W + (size_t)row * n;
  const float* trow = T + (size_t)row * V;
  float* erow = Werr + (size_t)row * n;     // written and read back here
  float tv[8];                               // codewords lane + 32 k
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int s = lane + 32 * k;
    tv[k] = s < V ? __ldg(trow + s) : 0.f;
  }
  for (int j = n - 1; j >= 0; --j) {
    const float* lt = Lt + (size_t)j * n;
    float part = 0.f;
    for (int l = j + 1 + lane; l < n; l += 32) part = fmaf(erow[l], __ldg(lt + l), part);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
    const float w = __ldg(wrow + j);
    const float eff = w + part / __ldg(lt + j);
    float best = INFINITY;
    int q = 1 << 30;                         // lanes without codewords lose
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int s = lane + 32 * k;
      if (s < V) {
        const float d = fabsf(eff - tv[k]);
        if (q == (1 << 30) || d < best) {
          best = d;
          q = s;
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oq = __shfl_xor_sync(0xffffffffu, q, o);
      if (ob < best || (ob == best && oq < q)) {
        best = ob;
        q = oq;
      }
    }
    if (lane == 0) {
      erow[j] = w - __ldg(trow + q);
      Q[(size_t)row * n + j] = q;
    }
    __syncwarp();
  }
}

}  // namespace

// Blocked S-step. Werr and Q are [m, n]; Rt is scratch of kBlk * m floats.
// Returns the first CUDA error of the launches (0 when all were accepted).
extern "C" int ganq_sstep_blocked(const void* W, const void* L, const void* T,
                                  void* Werr, void* Q, void* Rt, int m, int n,
                                  int V, void* stream) {
  if (m <= 0 || n <= 0 || V < 2 || V > 256) return (int)cudaErrorInvalidValue;
  const size_t smem = walk_smem_bytes(V);
  cudaError_t err = cudaFuncSetAttribute(
      walk_block, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const float*>(W);
  const auto* l = static_cast<const float*>(L);
  const auto* t = static_cast<const float*>(T);
  auto* e = static_cast<float*>(Werr);
  auto* q = static_cast<int*>(Q);
  auto* rt = static_cast<float*>(Rt);
  const int nb = (n + kBlk - 1) / kBlk;
  for (int bi = nb - 1; bi >= 0; --bi) {
    const int b0 = bi * kBlk, b1 = b0 + kBlk < n ? b0 + kBlk : n;
    const int bw = b1 - b0;
    if (b1 < n) {
      trailing_product<<<dim3((m + kPm - 1) / kPm, (bw + kPn - 1) / kPn), kPt,
                         0, s>>>(e, l, rt, m, n, b0, bw, b1);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    walk_block<<<(m + kWr - 1) / kWr, kWr, smem, s>>>(
        w, l, t, b1 < n ? rt : nullptr, e, q, m, n, V, b0, bw);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Per-column S-step. Lt is L transposed ([n, n], row j = column j of L).
extern "C" int ganq_sstep_columns(const void* W, const void* Lt, const void* T,
                                  void* Werr, void* Q, int m, int n, int V,
                                  void* stream) {
  if (m <= 0 || n <= 0 || V < 2 || V > 256) return (int)cudaErrorInvalidValue;
  walk_columns<<<(m + kCw - 1) / kCw, kCw * 32, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const float*>(Lt),
      static_cast<const float*>(T), static_cast<float*>(Werr),
      static_cast<int*>(Q), m, n, V);
  return (int)cudaGetLastError();
}
