// Fused W8A8 decode kernels 9-11 for Hopper (sm_90a). Each C entry point
// runs its kernel as a short fixed sequence of launches on the caller's
// stream, one phase of w8a8_fused.cuh each (a launch boundary is the barrier
// a cross-block reduction needs).
//
// * ganq_fused_mlp replaces ganq_tpu/ops/fused_mlp.py fused_mlp_w8a8 (Pallas
//   _fused_mlp_kernel, kernel 9): norm + int8 rows of x; gate/up, act, the
//   per-tile max; the per-tile int8 activations; the down product, one warp
//   per output row, summed over tiles in tile order, times ds, plus the
//   residual. The [B, I] activation goes through device memory (float32 and
//   int8; at B = 8, I = 8192 that is 320 KB, which stays in L2).
// * ganq_fused_qkv_rope replaces fused_attention.py fused_qkv_rope_w8a8
//   (_qkv_kernel, kernel 10): norm + int8 rows; the qkv product with bias and
//   rope, one warp per row pair (a rope pair reads its partner's value
//   directly, where the TPU kernel multiplies by a sign permutation).
// * ganq_attn_half replaces fused_layer.py attn_half_decode_w8a8
//   (_attn_half_kernel, kernel 11): kernel 10's two phases (also writing the
//   current token's k/v); flash attention, one block per (batch row, kv
//   head); the o product over the K-major o_t with int32 atomics; the
//   residual.
//
// Bound on this card at decode batch: the int8 weight bytes (kernel 9: 3 I H;
// kernel 10: Dqkv H; kernel 11: (Dqkv + Dq) H plus the K/V history) over
// the memory rate, 3.35 TB/s on an H100 SXM. The weight rows are read once
// per token group of up to 8 rows, in 16-byte loads per lane, four dp4a per
// load and token; the phases in between move kilobytes. Making them fast
// (fewer launches, the weight stream kept busy across phases) is later work.

#include "w8a8_fused.cuh"

namespace {

// ------------------------------------------------------------ kernels
template <typename XT>
__global__ void __launch_bounds__(kThreads)
norm_quant_kernel(W8A8Args a, const float* w) {
  __shared__ float red[kWarps];
  for (int b = blockIdx.x; b < a.B; b += gridDim.x)
    row_norm_quant<XT>(static_cast<const XT*>(a.x) + (size_t)b * a.Kx, a.H,
                       a.Kx, w, a.eps, a.rms_offset, a.x8 + (size_t)b * a.Kx,
                       a.sx + b, red);
}

template <int TB>
__global__ void __launch_bounds__(kThreads) qkv_kernel(W8A8Args a) {
  extern __shared__ __align__(16) int8_t xs[];
  phase_qkv<TB>(a, a.qkv_w8, a.qkv_scale, a.qkv_bias, a.x8, a.sx, a.qkv_out,
                a.kn, a.vn, xs);
}

__global__ void __launch_bounds__(kThreads) attn_kernel(W8A8Args a) {
  extern __shared__ __align__(16) float fs[];
  const int Hkv = a.kv_dim / a.d;
  for (int u = blockIdx.x; u < a.B * Hkv; u += gridDim.x) {
    const int b = u / Hkv, g = u - b * Hkv;
    const size_t off = (size_t)b * a.cache_sb + (size_t)g * a.cache_sg;
    attn_unit(a, b, g, a.qkv_out, a.k_cache + off, a.v_cache + off, a.attn,
              a.attn_amax, fs, *a.pos);
  }
}

template <int TB>
__global__ void __launch_bounds__(kThreads) oproj_kernel(W8A8Args a) {
  __shared__ int a8w[TB * 16];
  __shared__ float sa[TB];
  phase_oproj<TB>(a, a.o_t_w8, a.attn, a.attn_amax, a.o32, a8w, sa);
}

// y = x + ((float)o32 * sa) * o_scale, in x's type
template <typename XT>
__global__ void __launch_bounds__(kThreads) attn_resid_kernel(W8A8Args a) {
  const int Hkv = a.kv_dim / a.d;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    float m = 1e-12f;
    for (int g = 0; g < Hkv; ++g) m = fmaxf(m, a.attn_amax[b * Hkv + g]);
    const float sa = m / 127.f;
    const XT* x = static_cast<const XT*>(a.x) + (size_t)b * a.H;
    XT* y = static_cast<XT*>(a.y) + (size_t)b * a.H;
    for (int n = threadIdx.x; n < a.H; n += kThreads) {
      const float o = __fmul_rn(__fmul_rn((float)a.o32[(size_t)b * a.H + n],
                                          sa), a.o_t_scale[n]);
      store(y + n, __fadd_rn(to_f(x[n]), o));
    }
  }
}

template <int TB>
__global__ void __launch_bounds__(kThreads) gateup_kernel(W8A8Args a) {
  extern __shared__ __align__(16) int8_t xs[];
  phase_gateup<TB>(a, a.gateup_w8, a.gateup_scale, a.x8, a.sx, a.act_a,
                   a.amax, xs);
}

// a8 [B, I] = int8 codes of act [B, I] with each tile's scale
__global__ void __launch_bounds__(kThreads) tile_quant_kernel(W8A8Args a) {
  const int ng = a.I / a.ti;
  const size_t n = (size_t)a.B * a.I;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (size_t)gridDim.x * kThreads) {
    const int b = (int)(e / a.I), k = (int)(e - (size_t)b * a.I);
    a.a8[e] = (int8_t)quant8(a.act_a[e], tile_scale(a.amax, b, ng, k / a.ti));
  }
}

// y[b][n] = (sum over tiles t, in order, of (a8_t . down[n, tile t]) * sa_t)
// * ds[n] (+ x[b][n]); one warp per output row n, TB token rows per block
// row (blockIdx.y)
template <int TB, typename XT>
__global__ void __launch_bounds__(kThreads) mlp_down_kernel(W8A8Args a) {
  __shared__ __align__(16) int8_t as[TB * kDownChunk];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * kWarps + warp;
  const int b0 = blockIdx.y * TB, nb = min(TB, a.B - b0);
  const int ng = a.I / a.ti;
  const int8_t* row = a.down_w8 + (size_t)min(n, a.H - 1) * a.down_ld;
  float ma[TB];
#pragma unroll
  for (int b = 0; b < TB; ++b) ma[b] = 0.f;
  for (int t = 0; t < ng; ++t) {
    int acc[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) acc[b] = 0;
    const int end = (t + 1) * a.ti;
    for (int c0 = t * a.ti; c0 < end; c0 += kDownChunk) {
      const int cw = min(kDownChunk, end - c0), n16 = cw / 16;
      __syncthreads();
      for (int e = threadIdx.x; e < TB * n16; e += kThreads) {
        const int b = e / n16, c = e - b * n16;
        int4 v = make_int4(0, 0, 0, 0);
        if (b < nb)
          v = *reinterpret_cast<const int4*>(a.a8 + (size_t)(b0 + b) * a.I +
                                             c0 + 16 * c);
        reinterpret_cast<int4*>(as + b * kDownChunk)[c] = v;
      }
      __syncthreads();
      const int k = 16 * lane;
      if (k < cw) {
        const int4 w = __ldg(reinterpret_cast<const int4*>(row + c0 + k));
#pragma unroll
        for (int b = 0; b < TB; ++b) {
          const int4 xv = *reinterpret_cast<const int4*>(as + b * kDownChunk + k);
          int s = acc[b];
          s = __dp4a(w.x, xv.x, s); s = __dp4a(w.y, xv.y, s);
          s = __dp4a(w.z, xv.z, s); s = __dp4a(w.w, xv.w, s);
          acc[b] = s;
        }
      }
    }
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const int tot = __reduce_add_sync(0xffffffffu, acc[b]);
      if (b < nb)
        ma[b] = __fadd_rn(ma[b], __fmul_rn((float)tot,
                                           tile_scale(a.amax, b0 + b, ng, t)));
    }
  }
  if (n >= a.H) return;
#pragma unroll
  for (int b = 0; b < TB; ++b) {
    if (b == lane && b < nb) {
      float out = __fmul_rn(ma[b], a.down_scale[n]);
      if (a.fold_norm)
        out = __fadd_rn(out, to_f(static_cast<const XT*>(a.x)[(size_t)(b0 + b) * a.Kx + n]));
      store(static_cast<XT*>(a.y) + (size_t)(b0 + b) * a.H + n, out);
    }
  }
}

// ------------------------------------------------------------ launches
int token_tile(int B) { return B <= 1 ? 1 : B <= 2 ? 2 : B <= 4 ? 4 : 8; }

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

cudaError_t run_norm_quant(const W8A8Args& a, const float* w, cudaStream_t s) {
  if (a.x_bf16)
    norm_quant_kernel<bf16><<<a.B, kThreads, 0, s>>>(a, w);
  else
    norm_quant_kernel<float><<<a.B, kThreads, 0, s>>>(a, w);
  return cudaGetLastError();
}

template <int TB>
cudaError_t run_qkv_tb(const W8A8Args& a, cudaStream_t s) {
  const int units = (a.q_dim + 2 * a.kv_dim) / 2;
  const int blocks = (units + kWarps - 1) / kWarps * ((a.B + TB - 1) / TB);
  const size_t smem = (size_t)TB * a.H;
  cudaError_t e = allow_smem(qkv_kernel<TB>, smem);
  if (e != cudaSuccess) return e;
  qkv_kernel<TB><<<blocks, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

cudaError_t run_qkv(const W8A8Args& a, cudaStream_t s) {
  switch (token_tile(a.B)) {
    case 1: return run_qkv_tb<1>(a, s);
    case 2: return run_qkv_tb<2>(a, s);
    case 4: return run_qkv_tb<4>(a, s);
    default: return run_qkv_tb<8>(a, s);
  }
}

template <int TB>
cudaError_t run_oproj_tb(const W8A8Args& a, cudaStream_t s) {
  const int units = (a.q_dim / kKChunk) * ((a.H + kNCols - 1) / kNCols);
  oproj_kernel<TB><<<units, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <int TB>
cudaError_t run_mlp_tb(const W8A8Args& a, cudaStream_t s) {
  const int groups = (a.B + TB - 1) / TB;
  const size_t smem = (size_t)TB * a.Kx;
  cudaError_t e = allow_smem(gateup_kernel<TB>, smem);
  if (e != cudaSuccess) return e;
  gateup_kernel<TB><<<(a.I + kWarps - 1) / kWarps * groups, kThreads, smem, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const long long n = (long long)a.B * a.I;
  const long long want = (n + kThreads - 1) / kThreads;
  tile_quant_kernel<<<(int)(want < 4096 ? want : 4096), kThreads, 0, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const dim3 grid((a.H + kWarps - 1) / kWarps, groups);
  if (a.x_bf16)
    mlp_down_kernel<TB, bf16><<<grid, kThreads, 0, s>>>(a);
  else
    mlp_down_kernel<TB, float><<<grid, kThreads, 0, s>>>(a);
  return cudaGetLastError();
}

constexpr size_t kAttnSmem = sizeof(float) * kAttnSmemFloats;

}  // namespace

// Kernel 9. x [B, Kx] (bf16 if x_bf16 else f32; Kx = Hp, zero columns past
// H), attn_norm: the MLP's norm weight (f32 [H]) or null, gateup_w8
// [2I, Kx], gateup_scale [2I], down_w8 [H, down_ld], down_scale [H]; out y
// [B, H]; scratch x8 [B, Kx], sx [B], act_a [B, I], amax [B, I / ti],
// a8 [B, I].
extern "C" int ganq_fused_mlp(const W8A8Args* p, void* stream) {
  const W8A8Args a = *p;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(a.amax, 0,
                                  sizeof(int) * a.B * (a.I / a.ti), s);
  if (e != cudaSuccess) return (int)e;
  if ((e = run_norm_quant(a, a.fold_norm ? a.attn_norm : nullptr, s)) !=
      cudaSuccess)
    return (int)e;
  switch (token_tile(a.B)) {
    case 1: return (int)run_mlp_tb<1>(a, s);
    case 2: return (int)run_mlp_tb<2>(a, s);
    case 4: return (int)run_mlp_tb<4>(a, s);
    default: return (int)run_mlp_tb<8>(a, s);
  }
}

// Kernel 10. x [B, H], attn_norm (f32 [H]) or null, qkv_w8 [Dqkv, qkv_ld],
// qkv_scale and qkv_bias (or null) [Dqkv], cos/sin_half [rd / 2]; out
// qkv_out [B, Dqkv] bf16; scratch x8 [B, H], sx [B].
extern "C" int ganq_fused_qkv_rope(const W8A8Args* p, void* stream) {
  W8A8Args a = *p;
  a.kn = a.vn = nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = run_norm_quant(a, a.fold_norm ? a.attn_norm : nullptr, s);
  if (e != cudaSuccess) return (int)e;
  return (int)run_qkv(a, s);
}

// Kernel 11. As kernel 10, plus k/v_cache [B, T, Hkv, 128] bf16 (strides
// cache_sb/sg/st), pos (device int), o_t_w8 [o_rows, H], o_t_scale [H]; out
// y [B, H] in x's type, kn/vn [B, kv_dim] bf16; scratch qkv_out, attn
// [B, q_dim], attn_amax [B, Hkv], o32 [B, H].
extern "C" int ganq_attn_half(const W8A8Args* p, void* stream) {
  const W8A8Args a = *p;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(a.o32, 0, sizeof(int) * a.B * a.H, s);
  if (e != cudaSuccess) return (int)e;
  if ((e = run_norm_quant(a, a.fold_norm ? a.attn_norm : nullptr, s)) !=
      cudaSuccess)
    return (int)e;
  if ((e = run_qkv(a, s)) != cudaSuccess) return (int)e;
  attn_kernel<<<a.B * (a.kv_dim / a.d), kThreads, kAttnSmem, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  switch (token_tile(a.B)) {
    case 1: e = run_oproj_tb<1>(a, s); break;
    case 2: e = run_oproj_tb<2>(a, s); break;
    case 4: e = run_oproj_tb<4>(a, s); break;
    default: e = run_oproj_tb<8>(a, s); break;
  }
  if (e != cudaSuccess) return (int)e;
  if (a.x_bf16)
    attn_resid_kernel<bf16><<<a.B, kThreads, 0, s>>>(a);
  else
    attn_resid_kernel<float><<<a.B, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
