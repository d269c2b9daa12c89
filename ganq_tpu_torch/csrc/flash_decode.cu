// Single-token GQA attention over the KV cache for Hopper (sm_90a).
//
// Replaces ganq_tpu/ops/fused_attention.py:flash_decode_attention (the
// Pallas kernel _flash_decode_kernel). q, k and v are read as bf16; s =
// (q . k) * scale is summed in float; keys t > pos are masked to -1e30; the
// softmax is online over tiles of kTile keys, with a running max per tile
// and the sum l of the unrounded p in float; p is rounded to bf16 before
// p . v; spans of kSpan keys are rescaled to their common max and the output
// is acc / max(l, 1e-30) rounded to bf16. Those are the rounding points of
// ops/fused_attention.py:flash_decode_split_reference, which holds the
// kernel to about one bf16 ulp.
//
// Layouts: q [B, Hq, d]; k/v cache [B, T, Hkv, d], already holding the
// current token at row pos; out [B, Hq, d]; pos is one int32 read on the
// device, so a decode loop needs no host sync per step.
//
// Bound on this card: the K and V rows up to pos, 2 * B * (pos + 1) * Hkv *
// d * 2 bytes, over the memory rate (3.35 TB/s); the arithmetic, 4 * Hq * d
// FLOPs a key, is far below the card's rate. The TPU kernel walks the cache
// as a sequential grid axis. Here B * Hkv alone would leave most of the 132
// SMs idle at decode batch, so the keys are split in spans of kSpan and a
// block takes one (batch row, kv head, span). The design, one launch a call:
//
// * The grid is sized from the cache length T (pos stays on the device); a
//   block whose span starts past pos exits at once, before it reads the
//   cache, so cache rows past pos are never read and empty spans cost no
//   work.
// * A block copies the group's q (before it reads pos) and then its span's
//   K and V rows into shared memory with cp.async, all in flight at once (K
//   before V: the scores start when K has landed, while V arrives). Rows
//   past pos inside the span are zero-filled, not read. Row pitches are
//   padded by 16 bytes, so the eight rows of an ldmatrix fall in distinct
//   banks.
// * q . k on mma.sync m16n8k16: a warp takes 16 keys of the span (the M
//   side, A fragments by ldmatrix from the K rows) against the group's qpk
//   = Hq / Hkv query heads as the 8-wide N side, so each cache byte is read
//   once for the group.
// * The softmax takes a warp per head over the span's tiles in order; p is
//   stored rounded to bf16.
// * p . v on mma.sync too: warp w takes head-dimension rows 16 w .. + 15
//   (the M side, A fragments by transposing ldmatrix from the V rows)
//   against the heads (N, B fragments from p), one sum a tile, the tiles
//   added with their weights exp(m_j - m_last) in float.
// * The combine: each span leaves its running max, sum and unnormalised
//   output in float; the last block of a (row, kv head) to finish (an
//   arrival counter it resets itself) weighs the spans that hold keys <=
//   pos to the common max and divides: a thread an output, its spans' state
//   read 8 spans at a time, all of a batch's loads in flight together. A
//   single span writes its output directly. (Thread-block clusters combining through
//   distributed shared memory were measured slower: PERF.md.)

#include "mma_sync.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                 // keys per tile (running max)
constexpr int kSpanTiles = 2;
constexpr int kSpan = kTile * kSpanTiles; // keys per block
constexpr int kSPitch = kSpan + 4;        // floats of a head's scores
constexpr int kPPitch = 2 * kSpan + 16;   // bytes of a head's bf16 p
constexpr int kLoads = 8;                 // spans the combine reads at once
constexpr float kNegBig = -1e30f;
static_assert(kSpan == 16 * kWarps, "a warp scores 16 keys of the span");

// bytes of a staged K, V or q row: d bf16, zero-padded to a multiple of
// 16 (the mma's k), then by 16 bytes
__host__ __device__ __forceinline__ int pitch_of(int d) {
  return 2 * ((d + 15) / 16 * 16) + 16;
}

// dynamic shared memory: K and V spans, q (heads padded to a multiple of
// 8), the scores, p, the tile weights and each head's max and sum
size_t smem_bytes(int qpk, int d) {
  const size_t h8 = (qpk + 7) / 8 * 8;
  return 2 * (size_t)kSpan * pitch_of(d) + h8 * pitch_of(d) +
         sizeof(float) * (size_t)qpk * kSPitch + h8 * kPPitch +
         sizeof(float) * ((size_t)qpk * kSpanTiles + 2 * (size_t)qpk);
}

// Partial state of the spans, for the combine: part_acc [B * Hkv, nsplit,
// qpk * d], part_ml [B * Hkv, nsplit, 2, qpk]; counts [B * Hkv] arrival
// counters, zero between calls.
__global__ void __launch_bounds__(kThreads, 4)
flash_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kc,
                    const bf16* __restrict__ vc,
                    const int32_t* __restrict__ pos_ptr, bf16* __restrict__ out,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int* __restrict__ counts, int T, int Hkv, int qpk, int d,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = pitch_of(d);
  const int h8 = (qpk + 7) / 8 * 8;            // heads padded to n8 tiles
  unsigned char* k_s = smem;
  unsigned char* v_s = k_s + kSpan * pitch;
  unsigned char* q_s = v_s + kSpan * pitch;    // [h8][pitch] bf16
  float* s_s = reinterpret_cast<float*>(q_s + h8 * pitch);   // [qpk][kSPitch]
  unsigned char* p_s = reinterpret_cast<unsigned char*>(s_s + qpk * kSPitch);
  float* w_s = reinterpret_cast<float*>(p_s + h8 * kPPitch);  // [qpk][tiles]
  float* m_s = w_s + qpk * kSpanTiles;         // [qpk]
  float* l_s = m_s + qpk;                      // [qpk]
  __shared__ int last_s;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bg = blockIdx.x;                   // b * Hkv + g
  const int b = bg / Hkv, gk = bg % Hkv;
  const int chunks = d / 8;                    // 16-byte chunks of a row
  const int dp = (d + 15) / 16 * 16;           // d padded with zeros
  const int cpad = dp / 8;
  const int span = blockIdx.y;
  const int t0 = span * kSpan;
  const size_t qoff = (size_t)bg * qpk * d;

  // the group's q (it does not wait for pos); padding heads and columns
  // zero
  for (int e = tid; e < h8 * cpad; e += kThreads) {
    const int h = e / cpad, c = e % cpad;
    const bool ok = h < qpk && c < chunks;
    cp_async16(q_s + h * pitch + c * 16,
               q + qoff + (ok ? (size_t)h * d + c * 8 : 0), ok);
  }
  cp_async_commit();
  const int n = min(*pos_ptr + 1, T);          // keys 0..pos
  if (t0 >= n) {                               // nothing of this span to read
    cp_async_wait<0>();
    return;
  }
  const int nact = (n + kSpan - 1) / kSpan;    // spans that hold keys
  const int nk = min(kSpan, n - t0);           // this span's keys
  const size_t row0 = ((size_t)b * T + t0) * Hkv + gk;   // in rows of d
#pragma unroll
  for (int kv = 0; kv < 2; ++kv) {             // K, then V: a group each
    const bf16* src = kv ? vc : kc;
    unsigned char* dst = kv ? v_s : k_s;
    for (int e = tid; e < kSpan * cpad; e += kThreads) {
      const int r = e / cpad, c = e % cpad;
      const bool ok = r < nk && c < chunks;
      cp_async16(dst + r * pitch + c * 16,
                 src + (row0 + (size_t)(ok ? r : 0) * Hkv) * d +
                     (ok ? c * 8 : 0),
                 ok);
    }
    cp_async_commit();
  }

  // scores: warp w, keys 16 w .. + 15 against each n8 tile of heads
  cp_async_wait<1>();   // q and K landed
  __syncthreads();
  {
    const unsigned char* ka =
        k_s + (16 * warp + (lane & 15)) * pitch + (lane >> 4) * 16;
    for (int nt = 0; nt < h8 / 8; ++nt) {
      const unsigned char* qb = q_s + (nt * 8 + g) * pitch + 4 * t;
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int ks = 0; ks < dp / 16; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, ka + ks * 32);
        mma_bf16(sc, a, *reinterpret_cast<const uint32_t*>(qb + ks * 32),
                 *reinterpret_cast<const uint32_t*>(qb + ks * 32 + 16));
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int key = 16 * warp + g + 8 * (k >> 1);
        const int h = nt * 8 + 2 * t + (k & 1);
        if (h < qpk)
          s_s[h * kSPitch + key] = key < nk ? sc[k] * scale : kNegBig;
      }
    }
  }
  __syncthreads();

  // online softmax over the span's tiles, a warp per head: p rounded to
  // bf16, the tiles' weights exp(m_j - m_last)
  for (int h = warp; h < qpk; h += kWarps) {
    const float* sh = s_s + h * kSPitch;
    bf16* ph = reinterpret_cast<bf16*>(p_s + h * kPPitch);
    float m = kNegBig, mj[kSpanTiles], lj[kSpanTiles];
#pragma unroll
    for (int j = 0; j < kSpanTiles; ++j) {
      const int ta = j * kTile + lane, tb = ta + 32;
      const float sa = sh[ta], sb = sh[tb];
      float mx = fmaxf(sa, sb);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      m = fmaxf(m, mx);
      mj[j] = m;
      const float pa = ta < nk ? expf(sa - m) : 0.f;
      const float pb = tb < nk ? expf(sb - m) : 0.f;
      float sum = pa + pb;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      lj[j] = sum;
      ph[ta] = __float2bfloat16(pa);
      ph[tb] = __float2bfloat16(pb);
    }
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < kSpanTiles; ++j) {
      const float w = expf(mj[j] - m);
      l += lj[j] * w;
      if (lane == 0) w_s[h * kSpanTiles + j] = w;
    }
    if (lane == 0) {
      m_s[h] = m;
      l_s[h] = l;
    }
  }
  cp_async_wait<0>();   // V landed
  __syncthreads();

  // p . v: warp w, head-dimension rows 16 w .. + 15 against each n8 tile of
  // heads, a sum a tile
  const bool single = nact == 1;
  const int nout = qpk * d;
  for (int dt = warp; dt < dp / 16; dt += kWarps) {
    const unsigned char* va =
        v_s + ((lane & 7) + ((lane >> 4) & 1) * 8) * pitch + dt * 32 +
        ((lane >> 3) & 1) * 16;
    for (int nt = 0; nt < h8 / 8; ++nt) {
      const unsigned char* pb = p_s + (nt * 8 + g) * kPPitch + 4 * t;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kSpanTiles; ++j) {
        float pv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kc = 0; kc < kTile / 16; ++kc) {
          const int key0 = j * kTile + kc * 16;
          if (key0 >= nk) break;               // uniform across the block
          uint32_t a[4];
          ldmatrix_x4_trans(a, va + key0 * pitch);
          mma_bf16(pv, a, *reinterpret_cast<const uint32_t*>(pb + key0 * 2),
                   *reinterpret_cast<const uint32_t*>(pb + key0 * 2 + 16));
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int h = min(nt * 8 + 2 * t + (k & 1), qpk - 1);
          acc[k] += pv[k] * w_s[h * kSpanTiles + j];
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int h = nt * 8 + 2 * t + (k & 1);
        const int dd = dt * 16 + g + 8 * (k >> 1);
        if (h >= qpk || dd >= d) continue;
        if (single)
          out[qoff + h * d + dd] =
              __float2bfloat16(acc[k] / fmaxf(l_s[h], 1e-30f));
        else
          part_acc[((size_t)bg * gridDim.y + span) * nout + h * d + dd] =
              acc[k];
      }
    }
  }
  if (single) return;
  float* ml = part_ml + ((size_t)bg * gridDim.y + span) * 2 * qpk;
  for (int h = tid; h < qpk; h += kThreads) {
    ml[h] = m_s[h];
    ml[qpk + h] = l_s[h];
  }

  // the last span block of this (row, kv head) to arrive combines
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(counts + bg, 1);
    last_s = prev == nact - 1;
    if (last_s) counts[bg] = 0;   // ready for the next call
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const size_t sp0 = (size_t)bg * gridDim.y;
  // a thread an output: the spans' max, sum and output of its head read in
  // batches of kLoads, each batch's loads issued together
  for (int o = tid; o < nout; o += kThreads) {
    const int h = o / d;
    const float* pm = part_ml + sp0 * 2 * qpk + h;
    const float* pa = part_acc + sp0 * nout + o;
    float mx = kNegBig, a = 0.f, l = 0.f;
    for (int s0 = 0; s0 < nact; s0 += kLoads) {
      float mv[kLoads], lv[kLoads], av[kLoads];
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const bool ok = s0 + i < nact;
        const size_t s = s0 + i;
        mv[i] = ok ? __ldcg(pm + s * 2 * qpk) : kNegBig;
        lv[i] = ok ? __ldcg(pm + s * 2 * qpk + qpk) : 0.f;
        av[i] = ok ? __ldcg(pa + s * nout) : 0.f;
      }
      float bm = mx;
#pragma unroll
      for (int i = 0; i < kLoads; ++i) bm = fmaxf(bm, mv[i]);
      const float r = expf(mx - bm);   // the earlier batches to the new max
      a *= r;
      l *= r;
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const float w = expf(mv[i] - bm);
        a = fmaf(av[i], w, a);
        l = fmaf(lv[i], w, l);
      }
      mx = bm;
    }
    out[qoff + o] = __float2bfloat16(a / fmaxf(l, 1e-30f));
  }
}

}  // namespace

// q [B, Hq, d], k/v cache [B, T, Hkv, d], out [B, Hq, d], all bf16,
// contiguous and 16-byte aligned; pos: one int32 on the device. nsplit must
// be ceil(T / 128); part_acc holds B * Hkv * nsplit * Hq/Hkv * d floats and
// part_ml B * Hkv * nsplit * 2 * Hq/Hkv floats of scratch; counts B * Hkv
// ints that are zero (the kernel leaves them zero). Requires Hq = Hkv * qpk,
// d % 8 == 0, d <= 128 and qpk <= 32. One launch; returns its cudaError_t.
extern "C" int ganq_flash_decode(const void* q, const void* k_cache,
                                 const void* v_cache, const void* pos,
                                 void* out, void* part_acc, void* part_ml,
                                 void* counts, int B, int T, int Hkv, int qpk,
                                 int d, int nsplit, float scale,
                                 void* stream) {
  if (d % 8 || d > 128 || qpk < 1 || qpk > 32 ||
      nsplit != (T + kSpan - 1) / kSpan)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(qpk, d);
  static size_t allowed = 48 * 1024;   // raised to the most asked so far
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed = smem;
  }
  flash_decode_kernel<<<dim3(B * Hkv, nsplit), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_cache),
      static_cast<const bf16*>(v_cache), static_cast<const int32_t*>(pos),
      static_cast<bf16*>(out), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), static_cast<int*>(counts), T, Hkv, qpk,
      d, scale);
  return (int)cudaGetLastError();
}
