// Single-token GQA attention over the KV cache for Hopper (sm_90a).
//
// Replaces ganq_tpu/ops/fused_attention.py:flash_decode_attention (the
// Pallas kernel _flash_decode_kernel), with the same rounding points:
// q, k and v are read as bf16; s = (q . k) * scale is summed in float; keys
// t > pos are masked to -1e30; the softmax is online, with a running max and
// sum in float, per tile of kTile keys; p is rounded to bf16 before p . v;
// the output is acc / max(l, 1e-30) rounded to bf16.
//
// Layouts: q [B, Hq, d]; k/v cache [B, T, Hkv, d], already holding the
// current token at row pos; out [B, Hq, d]; pos is one int32 read on the
// device, so a decode loop needs no host sync per step.
//
// Bound on this card: the K and V rows up to pos, 2 * B * (pos + 1) * Hkv *
// d * 2 bytes, over the memory rate; the arithmetic is 4 * Hq * d FLOPs per
// key, far below the card's rate. The TPU kernel walks the cache as a
// sequential grid axis; here the keys are split in spans of kSplitKeys and
// each block takes one (batch row, kv head, span), walking its span in tiles
// of kTile keys with a loop. B * Hkv alone would leave most of the 132 SMs
// idle at decode batch. A block whose span starts past pos reads no cache
// row and leaves an empty state: cache rows past pos are never read (the
// Pallas kernel fetched those tiles and skipped only their math). Each tile of K and V is copied into shared
// memory with 16-byte loads (rows padded by one word so the per-key dot
// products are free of bank conflicts), and all qpk = Hq / Hkv query heads
// of the group share it, so every cache byte is read once. Each span leaves
// its running max, sum and unnormalised output in float, and a second
// kernel rescales them to the common max and divides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;        // keys per tile
constexpr int kSplitKeys = 128;  // keys per block (two tiles)
constexpr int kMaxAcc = 16;      // outputs per thread: qpk * d <= 16 * 256
constexpr float kNegBig = -1e30f;

// Writes the span's partial state: part_acc [B * Hkv, nsplit, qpk * d],
// part_ml [B * Hkv, nsplit, 2, qpk].
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ kc,
                    const __nv_bfloat16* __restrict__ vc,
                    const int32_t* __restrict__ pos_ptr,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int T, int Hkv, int qpk, int d, float scale) {
  extern __shared__ uint32_t smem[];
  const int rw = d / 2 + 1;                    // padded row, in 32-bit words
  uint32_t* k_s = smem;                        // [kTile][rw] bf16 pairs
  uint32_t* v_s = k_s + kTile * rw;
  float* q_s = reinterpret_cast<float*>(v_s + kTile * rw);   // [qpk][d]
  float* p_s = q_s + qpk * d;                  // [qpk][kTile]
  float* m_s = p_s + qpk * kTile;              // [qpk]
  float* l_s = m_s + qpk;
  float* a_s = l_s + qpk;

  const int tid = threadIdx.x;
  const int bg = blockIdx.x;                   // b * Hkv + g
  const int b = bg / Hkv;
  const int g = bg % Hkv;
  const int n = min(*pos_ptr + 1, T);          // keys 0..pos
  const int t_begin = blockIdx.y * kSplitKeys;
  const int t_end = min(t_begin + kSplitKeys, n);
  const int nout = qpk * d;

  for (int e = tid; e < nout; e += kThreads)
    q_s[e] = __bfloat162float(q[(size_t)bg * nout + e]);
  for (int h = tid; h < qpk; h += kThreads) {
    m_s[h] = kNegBig;
    l_s[h] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) acc[j] = 0.f;

  const int chunks = d / 8;                    // 16-byte chunks per row
  const int warp = tid >> 5, lane = tid & 31;
  for (int t0 = t_begin; t0 < t_end; t0 += kTile) {
    const int nt = min(kTile, t_end - t0);
    __syncthreads();                           // previous tile fully used
    for (int e = tid; e < nt * chunks; e += kThreads) {
      const int r = e / chunks, c = e % chunks;
      const size_t off = (((size_t)b * T + t0 + r) * Hkv + g) * d + c * 8;
      const uint4 kk = *reinterpret_cast<const uint4*>(kc + off);
      const uint4 vv = *reinterpret_cast<const uint4*>(vc + off);
      uint32_t* kr = k_s + r * rw + c * 4;
      uint32_t* vr = v_s + r * rw + c * 4;
      kr[0] = kk.x; kr[1] = kk.y; kr[2] = kk.z; kr[3] = kk.w;
      vr[0] = vv.x; vr[1] = vv.y; vr[2] = vv.z; vr[3] = vv.w;
    }
    __syncthreads();

    // scores, one (head, key) pair per thread and step
    for (int e = tid; e < qpk * kTile; e += kThreads) {
      const int h = e / kTile, t = e % kTile;
      float s = kNegBig;
      if (t < nt) {
        const uint32_t* kr = k_s + t * rw;
        const float* qh = q_s + h * d;
        float dot = 0.f;
        for (int i2 = 0; i2 < d / 2; ++i2) {
          const __nv_bfloat162 kv2 =
              *reinterpret_cast<const __nv_bfloat162*>(kr + i2);
          dot = fmaf(qh[2 * i2], __low2float(kv2), dot);
          dot = fmaf(qh[2 * i2 + 1], __high2float(kv2), dot);
        }
        s = dot * scale;
      }
      p_s[h * kTile + t] = s;
    }
    __syncthreads();

    // online softmax update, one warp per head
    for (int h = warp; h < qpk; h += kThreads / 32) {
      float* ph = p_s + h * kTile;
      const float s0 = ph[lane], s1 = ph[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[h];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      ph[lane] = __bfloat162float(__float2bfloat16(p0));
      ph[lane + 32] = __bfloat162float(__float2bfloat16(p1));
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[h] = alpha;
        l_s[h] = l_s[h] * alpha + sum;
        m_s[h] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . v for this thread's (head, lane) outputs
    const __nv_bfloat16* vb = reinterpret_cast<const __nv_bfloat16*>(v_s);
#pragma unroll
    for (int j = 0; j < kMaxAcc; ++j) {
      const int o = tid + j * kThreads;
      if (o >= nout) break;
      const int h = o / d, i = o % d;
      const float* ph = p_s + h * kTile;
      float pv = 0.f;
      for (int t = 0; t < nt; ++t)
        pv = fmaf(ph[t], __bfloat162float(vb[t * 2 * rw + i]), pv);
      acc[j] = acc[j] * a_s[h] + pv;
    }
  }
  __syncthreads();

  const size_t span = (size_t)bg * gridDim.y + blockIdx.y;
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) {
    const int o = tid + j * kThreads;
    if (o >= nout) break;
    part_acc[span * nout + o] = acc[j];
  }
  for (int h = tid; h < qpk; h += kThreads) {
    part_ml[span * 2 * qpk + h] = m_s[h];
    part_ml[span * 2 * qpk + qpk + h] = l_s[h];
  }
}

// Rescale every span's partial state to the common max and divide.
__global__ void __launch_bounds__(kThreads)
flash_decode_combine_kernel(const float* __restrict__ part_acc,
                            const float* __restrict__ part_ml,
                            __nv_bfloat16* __restrict__ out, int qpk, int d,
                            int nsplit) {
  const int bg = blockIdx.x;
  const int nout = qpk * d;
  const float* ml = part_ml + (size_t)bg * nsplit * 2 * qpk;
  const float* pa = part_acc + (size_t)bg * nsplit * nout;
  for (int o = threadIdx.x; o < nout; o += kThreads) {
    const int h = o / d;
    float mx = kNegBig;
    for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, ml[s * 2 * qpk + h]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float w = expf(ml[s * 2 * qpk + h] - mx);
      l = fmaf(ml[s * 2 * qpk + qpk + h], w, l);
      a = fmaf(pa[(size_t)s * nout + o], w, a);
    }
    out[(size_t)bg * nout + o] = __float2bfloat16(a / fmaxf(l, 1e-30f));
  }
}

size_t smem_bytes(int qpk, int d) {
  const size_t rw = d / 2 + 1;
  return (2 * kTile * rw + (size_t)qpk * d + (size_t)qpk * kTile + 3 * qpk) *
         sizeof(uint32_t);
}

cudaError_t allow_smem(size_t smem) {
  static size_t allowed = 48 * 1024;   // raised once, not per launch
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess) allowed = smem;
  return err;
}

}  // namespace

// q [B, Hq, d], k/v cache [B, T, Hkv, d], out [B, Hq, d], all bf16 and
// contiguous; pos: one int32 on the device. nsplit must be
// ceil(T / 128); part_acc holds B * Hkv * nsplit * Hq/Hkv * d floats and
// part_ml B * Hkv * nsplit * 2 * Hq/Hkv floats of scratch.
// Requires Hq = Hkv * qpk, d % 8 == 0, d <= 128 and qpk * d <= 4096.
// Returns the cudaError_t of the launches.
extern "C" int ganq_flash_decode(const void* q, const void* k_cache,
                                 const void* v_cache, const void* pos,
                                 void* out, void* part_acc, void* part_ml,
                                 int B, int T, int Hkv, int qpk, int d,
                                 int nsplit, float scale, void* stream) {
  if (d % 8 || d > 128 || qpk * d > kMaxAcc * kThreads ||
      nsplit != (T + kSplitKeys - 1) / kSplitKeys)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(qpk, d);
  const cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k_cache);
  const auto* vp = static_cast<const __nv_bfloat16*>(v_cache);
  const auto* pp = static_cast<const int32_t*>(pos);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* pa = static_cast<float*>(part_acc);
  auto* pm = static_cast<float*>(part_ml);
  flash_decode_kernel<<<dim3(B * Hkv, nsplit), kThreads, smem, s>>>(
      qp, kp, vp, pp, pa, pm, T, Hkv, qpk, d, scale);
  const cudaError_t launch = cudaGetLastError();
  if (launch != cudaSuccess) return (int)launch;
  flash_decode_combine_kernel<<<B * Hkv, kThreads, 0, s>>>(pa, pm, op, qpk, d,
                                                           nsplit);
  return (int)cudaGetLastError();
}
