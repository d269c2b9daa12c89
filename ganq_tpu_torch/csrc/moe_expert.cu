// One MoE layer's routed-expert MLP for decode-shaped rows (kernel 15), for
// Hopper (sm_90a).
//
// Replaces ganq_tpu/ops/moe_expert.py moe_expert_decode (Pallas
// _moe_kernel). The TPU kernel walks a sequential grid over (expert slot,
// MLP tile), its BlockSpecs steered by the slot ids through scalar
// prefetch, and keeps x8, the tile's activation and the [B, H] sum in VMEM.
// Here the blocks read the slot ids from device memory and the work is four
// short launches on the caller's stream (after zeroing the tile maxima):
//
//   1  x to int8 per token row (x8, sx), a block per row
//   2  gate/up for every (slot, packed row pair, token group of 8): a warp
//      per (gate, up) pair of expert slot_ids[s]'s planes, the grouped dot
//      of megastep_grouped.cuh (exact int32 group dots of the centred
//      codes, s_g * z_g summed over the groups in order), act(g sx) (u sx)
//      into act_a [S, B, I] and max|a| per (slot, token row, tile) (an
//      integer max on the float bits: exact in any order)
//   3  the activation to int8 per (slot, token row, tile): a8 [S, B, I]
//   4  the down product: a warp per two output rows and token group owns
//      y[b][n] and walks the slots, then the tiles, in order: ma +=
//      (y_st * sa_st) * w[b][s] (the TPU kernel's acc += y * sa * wt), so
//      every float sum is the TPU kernel's and no float atomics are used.
//
// Bound on this card: the routed experts' code bytes (3 H I bits / 8 each)
// and bf16 scales, over 3.35 TB/s; at Mixtral-8x7B widths 0.107 ms for two
// 8-bit experts (batch 1) and 0.427 ms for all eight. This first form reads
// each expert's weights once per token group (batches above 8 read them
// again, from L2 where they fit) and stages activations per block.

#include "megastep_grouped.cuh"

// ganq_tpu_torch/ops/moe_expert.py MoeArgs (same field order): x [B, H]
// float32 (B <= 32), slot_ids [S] int32, wts [B, S] float32; moe_megapack's
// gate_pk [E, 2 I / F, H] int8, gu_s [E, G, 2 I] bf16 tile-interleaved,
// dn_pk [E, H / F, I], dn_s [E, NG * gtp, H] bf16 (F = 8 / bits rows a
// byte); out y [B, H] float32; scratch x8 [B, H], sx [B], act_a [S, B, I],
// amax [S, B, I / ti], a8 [S, B, I].
struct MoeArgs {
  int B, H, I, ti, S, gs, bits, act, gtp;
  const float* x;
  const int* slot_ids;
  const float* wts;
  const int8_t* gate_pk;
  const bf16* gu_s;
  const int8_t* dn_pk;
  const bf16* dn_s;
  float* y;
  int8_t* x8;
  float* sx;
  float* act_a;
  int* amax;
  int8_t* a8;
};

namespace {

__global__ void __launch_bounds__(kThreads) moe_quant_x(MoeArgs a) {
  __shared__ float red[kWarps];
  const int b = blockIdx.x;
  row_norm_quant<float>(a.x + (size_t)b * a.H, a.H, a.H, nullptr, 0.f, 0.f,
                        a.x8 + (size_t)b * a.H, a.sx + b, red);
}

template <int TB, int BITS>
__global__ void __launch_bounds__(kThreads) moe_gateup(MoeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int F = BITS == 4 ? 2 : 1;
  constexpr int FT = F * TB;
  constexpr int kPf = pf_floats<TB, BITS>();
  float* pf = reinterpret_cast<float*>(smem) + (threadIdx.x >> 5) * kPf;
  int8_t* xs = reinterpret_cast<int8_t*>(smem + kWarps * kPf * sizeof(float));
  const int H = a.H, I = a.I, ti = a.ti, ng = I / ti, G = H / a.gs;
  const int tF = ti / F, PI = I / F;
  const int nrb = (PI + kWarps - 1) / kWarps;
  const int groups = (a.B + TB - 1) / TB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int staged = -1;
  for (int bu = blockIdx.x; bu < a.S * nrb * groups; bu += gridDim.x) {
    const int s = bu / (nrb * groups), rem = bu - s * nrb * groups;
    const int rb = rem / groups, grp = rem - rb * groups;
    const int b0 = grp * TB, nb = min(TB, a.B - b0);
    if (grp != staged) {
      __syncthreads();
      stage_rows_ld<TB>(a.x8, H, 0, b0, nb, H, xs);
      staged = grp;
    }
    const int p = rb * kWarps + warp;
    if (p >= PI) continue;
    const int e = __ldg(a.slot_ids + s);
    const int8_t* pk = a.gate_pk + (size_t)e * 2 * PI * H;
    const bf16* sc = a.gu_s + (size_t)e * G * 2 * I;
    const int t = p / tF, i = p - t * tF;
    const int8_t* rows[2] = {pk + (size_t)p * H, pk + (size_t)(PI + p) * H};
    const float y = group_dot<TB, BITS, 2, false>(
        rows, H, xs, a.gs, true, pf,
        [&](int v, int g) {
          const int r = v / FT, f = (v / TB) % F;
          return bf(sc, (size_t)g * 2 * I + (size_t)(2 * t + r) * ti +
                            f * tF + i);
        },
        [](int, int) { return 0.f; });
    const float yu = __shfl_sync(0xffffffffu, y,
                                 lane < FT ? lane + FT : lane);
    const int b = lane % TB, f = (lane / TB) % F;
    if (lane >= FT || b >= nb) continue;
    const float sxb = a.sx[b0 + b];
    const float v = gated(__fmul_rn(y, sxb), __fmul_rn(yu, sxb), a.act);
    const size_t row = (size_t)s * a.B + b0 + b;
    a.act_a[row * I + t * ti + f * tF + i] = v;
    atomicMax(a.amax + row * ng + t, __float_as_int(fabsf(v)));
  }
}

__global__ void __launch_bounds__(kThreads) moe_quant_a(MoeArgs a) {
  const int ng = a.I / a.ti;
  const size_t n = (size_t)a.S * a.B * a.I;
  for (size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x; e < n;
       e += (size_t)gridDim.x * kThreads) {
    const size_t row = e / a.I;
    const int m = (int)(e - row * a.I);
    a.a8[e] = (int8_t)quant8(a.act_a[e],
                             tile_scale(a.amax, (int)row, ng, m / a.ti));
  }
}

template <int TB, int BITS>
__global__ void __launch_bounds__(kThreads) moe_down(MoeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int F = BITS == 4 ? 2 : 1;
  constexpr int FT = F * TB, NR = 2 / F;
  constexpr int kPf = pf_floats<TB, BITS>();
  float* pf = reinterpret_cast<float*>(smem) + (threadIdx.x >> 5) * kPf;
  unsigned char* work = smem + kWarps * kPf * sizeof(float);
  float* sa_s = reinterpret_cast<float*>(work);
  float* wt_s = sa_s + TB;
  int8_t* xs = reinterpret_cast<int8_t*>(work + kSaBytes);
  const int H = a.H, I = a.I, ti = a.ti, ng = I / ti, P = H / F;
  const int units = P / NR, nrb = (units + kWarps - 1) / kWarps;
  const int groups = (a.B + TB - 1) / TB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int bu = blockIdx.x; bu < nrb * groups; bu += gridDim.x) {
    const int rb = bu / groups, grp = bu - rb * groups;
    const int b0 = grp * TB, nb = min(TB, a.B - b0);
    const int u = rb * kWarps + warp;
    auto row_of = [&](int v) { return ((v / TB) % F) * P + NR * u + v / FT; };
    float ma = 0.f;
    for (int s = 0; s < a.S; ++s) {
      const int e = __ldg(a.slot_ids + s);
      const int8_t* pk = a.dn_pk + (size_t)e * P * I;
      const bf16* sc = a.dn_s + (size_t)e * ng * a.gtp * H;
      const int* amax = a.amax + (size_t)s * a.B * ng;
      for (int t = 0; t < ng; ++t) {
        __syncthreads();
        if (threadIdx.x < TB) {
          const int b = threadIdx.x;
          sa_s[b] = b < nb ? tile_scale(amax, b0 + b, ng, t) : 1.f;
          wt_s[b] = b < nb ? a.wts[(size_t)(b0 + b) * a.S + s] : 0.f;
        }
        stage_rows_ld<TB>(a.a8 + (size_t)s * a.B * I, I, t * ti, b0, nb, ti,
                          xs);
        if (u < units) {
          const int8_t* rows[NR];
#pragma unroll
          for (int r = 0; r < NR; ++r)
            rows[r] = pk + (size_t)(NR * u + r) * I + (size_t)t * ti;
          const float y = group_dot<TB, BITS, NR, false>(
              rows, ti, xs, a.gs, true, pf,
              [&](int v, int g) {
                return bf(sc, (size_t)(t * a.gtp + g) * H + row_of(v));
              },
              [](int, int) { return 0.f; });
          if (lane < 2 * TB)
            ma = __fadd_rn(ma, __fmul_rn(__fmul_rn(y, sa_s[lane % TB]),
                                         wt_s[lane % TB]));
        }
      }
    }
    const int b = lane % TB;
    if (u >= units || lane >= 2 * TB || b >= nb) continue;
    a.y[(size_t)(b0 + b) * H + row_of(lane)] = ma;
  }
}

size_t staged_bytes(int TB, int K) { return (size_t)TB * ((K + 127) / 128) * kPad; }

template <int TB, int BITS>
cudaError_t launch_moe(const MoeArgs& a, cudaStream_t s) {
  constexpr size_t pf = kWarps * pf_floats<TB, BITS>() * sizeof(float);
  const int F = BITS == 4 ? 2 : 1, ng = a.I / a.ti;
  const size_t smem_gu = pf + staged_bytes(TB, a.H);
  const size_t smem_dn = pf + kSaBytes + staged_bytes(TB, a.ti);
  cudaError_t e;
  if ((e = cudaFuncSetAttribute(moe_gateup<TB, BITS>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem_gu)) != cudaSuccess)
    return e;
  if ((e = cudaFuncSetAttribute(moe_down<TB, BITS>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem_dn)) != cudaSuccess)
    return e;
  if ((e = cudaMemsetAsync(a.amax, 0, sizeof(int) * a.S * a.B * ng, s)) !=
      cudaSuccess)
    return e;
  const int groups = (a.B + TB - 1) / TB;
  moe_quant_x<<<a.B, kThreads, 0, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int nrb_gu = (a.I / F + kWarps - 1) / kWarps;
  moe_gateup<TB, BITS><<<a.S * nrb_gu * groups, kThreads, smem_gu, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const size_t n = (size_t)a.S * a.B * a.I;
  moe_quant_a<<<(int)std::min<size_t>((n + kThreads - 1) / kThreads, 4096),
                kThreads, 0, s>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int units = a.H / F / (2 / F);
  moe_down<TB, BITS><<<(units + kWarps - 1) / kWarps * groups, kThreads,
                       smem_dn, s>>>(a);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_moe_b(const MoeArgs& a, cudaStream_t s) {
  if (a.B <= 1) return launch_moe<1, BITS>(a, s);
  if (a.B <= 2) return launch_moe<2, BITS>(a, s);
  if (a.B <= 4) return launch_moe<4, BITS>(a, s);
  return launch_moe<kGroupTB, BITS>(a, s);
}

}  // namespace

// Returns the first failing launch's cudaError_t (0 on success).
extern "C" int ganq_moe_expert(const MoeArgs* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->B < 1 || p->B > 32 || p->S < 1 || p->I % p->ti || p->ti % p->gs ||
      p->H % p->gs || p->gs % 128)
    return (int)cudaErrorInvalidValue;
  if (p->bits == 4) return (int)launch_moe_b<4>(*p, s);
  if (p->bits == 8) return (int)launch_moe_b<8>(*p, s);
  return (int)cudaErrorInvalidValue;
}
