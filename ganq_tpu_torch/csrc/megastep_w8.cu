// Whole decode step over all layers in one launch, W8A8 (kernel 12), for
// Hopper (sm_90a).
//
// Replaces ganq_tpu/ops/megastep.py megastep_decode_w8a8 (Pallas
// _megastep_kernel), one pallas_call over the grid (layers, phases). Here it
// is one persistent cooperative launch (cudaLaunchCooperativeKernel): the
// grid is as many blocks as the card holds at once (occupancy times SMs), so
// every block is resident, and a cooperative-groups grid barrier separates
// the phases of each layer:
//
//   0  the residual of the previous layer's MLP (the tiles' int32 products
//      times their scales, summed in tile order, times ds), elementwise
//      over every block; then the attention norm and int8 rows, one block
//      per token row
//   1  zero the accumulators; qkv + bias + rope, one warp per row pair; the
//      current token's k/v out
//   2  flash attention, one block per (token row, kv head)
//   3  the o product over the K-major o_t, int32 atomics
//   4  residual ((o32 * sa) * o_scale into the float32 residual),
//      elementwise; then the MLP norm and int8 rows, one block per row
//   5  gate/up, act, the per-tile max, one warp per intermediate row
//   6  the down product over the K-major down_t, per tile int32 atomics
//
// and after the last layer its MLP residual and y = the residual in x's
// type. The residual stays float32 in device memory across all layers, as
// in the TPU kernel. Every block runs every phase and passes every barrier
// (no block leaves early), or the barrier would deadlock.
//
// Bound on this card: the int8 weight bytes of all layers, L (Dqkv + Dq +
// 3 I) H (2.82 GB at Llama-3.2-3B), plus the K/V history below pos, over
// 3.35 TB/s: 0.84 ms a step at batch 1 and short contexts. This simple form
// pays a grid barrier per phase (9 per layer, ~1.3 us each), leaves most of
// the card idle in the row and attention phases, and streams the weights
// only in the GEMV phases; overlapping them is later work.

#include <cooperative_groups.h>

#include "w8a8_fused.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRedBytes = 64;

// the residual of layer l's MLP into xs, element e = (b, n) of the rows:
// xs += (sum_t (float)part[t][b][n] * sa_t) * ds[n], tiles in order
__device__ __forceinline__ void mlp_residual(const W8A8Args& a, int l,
                                             size_t e) {
  const int ng = a.I / a.ti, b = (int)(e / a.H), n = (int)(e % a.H);
  float ma = 0.f;
#pragma unroll 8
  for (int t = 0; t < ng; ++t)
    ma = __fadd_rn(ma, __fmul_rn((float)a.part[((size_t)t * a.B + b) * a.H + n],
                                 tile_scale(a.amax, b, ng, t)));
  a.xs[e] = __fadd_rn(a.xs[e], __fmul_rn(ma, a.down_scale[(size_t)l * a.H + n]));
}

template <int TB, typename XT>
__global__ void __launch_bounds__(kThreads, 2) megastep_kernel(W8A8Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  unsigned char* work = smem + kRedBytes;
  const int H = a.H, I = a.I, ng = I / a.ti, Hkv = a.kv_dim / a.d;
  const int Dqkv = a.q_dim + 2 * a.kv_dim;
  const size_t tid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t nthreads = (size_t)gridDim.x * kThreads;

  for (int l = 0; l < a.L; ++l) {
    // 0: layer entry: the previous layer's MLP residual (every block), then
    // the attention norm and int8 rows (a block per token row)
    for (size_t e = tid; e < (size_t)a.B * H; e += nthreads) {
      if (l == 0)
        a.xs[e] = to_f(static_cast<const XT*>(a.x)[e]);
      else
        mlp_residual(a, l - 1, e);
    }
    grid.sync();
    for (int b = blockIdx.x; b < a.B; b += gridDim.x)
      row_norm_quant<float>(a.xs + (size_t)b * H, H, H,
                            a.attn_norm + (size_t)l * H, a.eps, a.rms_offset,
                            a.x8 + (size_t)b * H, a.sx + b, red);
    grid.sync();

    // 1: zero the accumulators; qkv + rope
    for (size_t e = tid; e < (size_t)a.B * H; e += nthreads) a.o32[e] = 0;
    for (size_t e = tid; e < (size_t)a.B * ng; e += nthreads) a.amax[e] = 0;
    for (size_t e = tid; e < (size_t)ng * a.B * H; e += nthreads) a.part[e] = 0;
    phase_qkv<TB>(a, a.qkv_w8 + (size_t)l * Dqkv * a.qkv_ld,
                  a.qkv_scale + (size_t)l * Dqkv, a.qkv_bias + (size_t)l * Dqkv,
                  a.x8, a.sx, a.qkv_out, a.kn + (size_t)l * a.B * a.kv_dim,
                  a.vn + (size_t)l * a.B * a.kv_dim,
                  reinterpret_cast<int8_t*>(work));
    grid.sync();

    // 2: attention
    for (int u = blockIdx.x; u < a.B * Hkv; u += gridDim.x) {
      const int b = u / Hkv, g = u - b * Hkv;
      const size_t off = (size_t)l * a.cache_sl + (size_t)b * a.cache_sb +
                         (size_t)g * a.cache_sg;
      attn_unit(a, b, g, a.qkv_out, a.k_cache + off, a.v_cache + off, a.attn,
                a.attn_amax, reinterpret_cast<float*>(work), *a.pos);
    }
    grid.sync();

    // 3: o product
    phase_oproj<TB>(a, a.o_t_w8 + (size_t)l * a.o_rows * H, a.attn,
                    a.attn_amax, a.o32, reinterpret_cast<int*>(work),
                    reinterpret_cast<float*>(work + TB * 16 * sizeof(int)));
    grid.sync();

    // 4: residual (every block), then the MLP norm and int8 rows (a block
    // per token row)
    for (size_t e = tid; e < (size_t)a.B * H; e += nthreads) {
      const int b = (int)(e / H), n = (int)(e % H);
      float m = 1e-12f;
      for (int g = 0; g < Hkv; ++g) m = fmaxf(m, a.attn_amax[b * Hkv + g]);
      a.xs[e] = __fadd_rn(a.xs[e], __fmul_rn(__fmul_rn(
          (float)a.o32[e], m / 127.f), a.o_t_scale[(size_t)l * H + n]));
    }
    grid.sync();
    for (int b = blockIdx.x; b < a.B; b += gridDim.x)
      row_norm_quant<float>(a.xs + (size_t)b * H, H, H,
                            a.mlp_norm + (size_t)l * H, a.eps, a.rms_offset,
                            a.x8 + (size_t)b * H, a.sx + b, red);
    grid.sync();

    // 5: gate/up
    phase_gateup<TB>(a, a.gateup_w8 + (size_t)l * 2 * I * H,
                     a.gateup_scale + (size_t)l * 2 * I, a.x8, a.sx, a.act_a,
                     a.amax, reinterpret_cast<int8_t*>(work));
    grid.sync();

    // 6: down
    phase_down_kmajor<TB>(a, a.down_w8 + (size_t)l * I * H, a.act_a, a.amax,
                          a.part, reinterpret_cast<int*>(work),
                          reinterpret_cast<float*>(work + TB * 16 * sizeof(int)));
    grid.sync();
  }

  // the last layer's MLP residual, then y
  for (size_t e = tid; e < (size_t)a.B * H; e += nthreads) {
    mlp_residual(a, a.L - 1, e);
    store(static_cast<XT*>(a.y) + e, a.xs[e]);
  }
}

size_t megastep_smem(const W8A8Args& a, int TB) {
  const size_t stage = (size_t)TB * a.H;
  const size_t attn = sizeof(float) * kAttnSmemFloats;
  const size_t kmaj = (size_t)TB * 16 * sizeof(int) + TB * sizeof(float);
  size_t m = stage > attn ? stage : attn;
  return kRedBytes + (m > kmaj ? m : kmaj);
}

template <int TB, typename XT>
cudaError_t launch(const W8A8Args& a, cudaStream_t s) {
  auto kernel = megastep_kernel<TB, XT>;
  const size_t smem = megastep_smem(a, TB);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         kThreads, smem)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  W8A8Args args = a;
  void* params[] = {&args};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                     dim3(per_sm * sms), dim3(kThreads),
                                     params, smem, s);
}

template <typename XT>
cudaError_t launch_x(const W8A8Args& a, cudaStream_t s) {
  const int B = a.B;
  if (B <= 1) return launch<1, XT>(a, s);
  if (B <= 2) return launch<2, XT>(a, s);
  if (B <= 4) return launch<4, XT>(a, s);
  return launch<8, XT>(a, s);
}

}  // namespace

// x [B, H] (bf16 if x_bf16 else f32, B <= 8); the megapack with a leading
// layer axis: attn_norm/mlp_norm [L, H], qkv_w8 [L, Dqkv, qkv_ld],
// qkv_scale/qkv_bias [L, Dqkv], o_t_w8 [L, o_rows, H], o_t_scale [L, H],
// gateup_w8 [L, 2I, H], gateup_scale [L, 2I], down_w8 = down_t [L, I, H],
// down_scale [L, H]; k/v_cache [L, B Hkv, T, 128] bf16 (strides cache_*),
// pos (device int), cos/sin_half [rd / 2]. Out y [B, H] in x's type and
// kn/vn [L, B, kv_dim] bf16. Scratch: qkv_out [B, Dqkv] bf16, x8 [B, H],
// sx [B], xs [B, H], act_a [B, I], amax [B, I / ti], attn [B, q_dim],
// attn_amax [B, Hkv], o32 [B, H], part [I / ti, B, H]. Returns the
// cudaError_t of the cooperative launch.
extern "C" int ganq_megastep_w8(const W8A8Args* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(p->x_bf16 ? launch_x<bf16>(*p, s) : launch_x<float>(*p, s));
}
