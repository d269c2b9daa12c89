// Whole decode step over all layers in one launch, group-scaled uniform
// weights with int8 activations, for Hopper (sm_90a): the phases and the
// persistent kernel of kernel 13 (megastep4.cu, ganq_megastep4) and kernel
// 14 (megastep_lowbit.cu, ganq_megastep_lowbit, variants "w4p" and "w8p";
// with zero points or act-order megastep_lowbit_opt.cu).
//
// Replaces ganq_tpu/ops/megastep4.py megastep4_decode (Pallas
// _megastep4_kernel) and ganq_tpu/ops/megastep_lowbit.py
// megastep_lowbit_decode (_megastep_lb_kernel, bits 4 and 8; of its
// optional operands the zero points *_sz and the act-order orders ap_*). The TPU kernels are one pallas_call walking (layers, phases)
// in order and dequantize by algebra on masked int8 MXU dots, because a TPU
// has no gather. Here a byte's codes are decoded by shift and mask: a
// pair-nibble byte holds the codes of two output rows (or, in kernel 13's
// K-major o and down, two output columns), and the warp that owns both
// decodes it once. The numbers are the TPU kernels': per group of gs
// columns the exact int32 dot z = x8 . (q - 2^(bits-1)) (the TPU's plane
// algebra gives the same integer), then y += s_g * z in float32, group
// after group in order, then y * sx. With zero points (kernel 14's *_sz)
// each group adds sz_g * S_g in float32 to its s_g * z_g, S_g the group's
// int8 activation sum; with act-order (ap_*) the qkv, gate/up and o phases
// stage their activation rows through the pack's column order (a gather in
// place of the TPU kernel's Benes lane routing: the same values).
//
// One cooperative launch (cudaLaunchCooperativeKernel; the grid is
// occupancy times SMs, every block runs every phase and passes every
// barrier). Per layer, with a grid barrier after each:
//
//   0  layer entry: the residual x (the input at layer 0; kernel 13 adds
//      the previous layer's MLP from its group partials)
//   1  attention norm and int8 rows, a block per token row
//   2  qkv + bias + rope, a warp per rope pair of packed rows; zero the
//      MLP tile maxima
//   3  flash attention, a block per (token row, kv head), each row at its
//      own history length pos[b]
//   4  the attention output's int8 rows (a8, one scale per token row)
//   5  the o product: kernel 14 a warp per two output rows, which adds
//      (sum_g s_g z_g) * sa to the residual row it owns; kernel 13 (K-major
//      o) a block per (group, 1024 byte columns) writing s_g * z_g, then an
//      elementwise pass summing the groups in order into the residual
//   6  MLP norm and int8 rows
//   7  gate/up, a warp per (gate, up) packed row pair: act(g) * u and the
//      per-tile max|a| (integer max on float bits)
//   8  the activation's int8 rows per MLP tile
//   9  the down product: kernel 14 a warp per two output rows walking the
//      ti tiles in order (ma += y_t * sa_t, then x += ma); kernel 13 group
//      partials as in 5, summed at the next layer's entry
//
// and after the last layer y = x. The residual stays float32 in device
// memory. Row-major products (a warp per packed rows, a lane per group of
// gs columns) stage up to 8 token rows of int8 activations in shared
// memory; batches above 8 walk token groups of 8, the token group the inner
// unit index so that concurrent blocks read the same weight rows (from L2
// after the first). Each lane forms its group's exact int32 dots and their
// scaled float32 values, and one lane per (row, token) sums the groups in
// order from shared memory: no float atomics, so no order depends on the
// blocks.
//
// Bound on this card: the weight bytes, L (Dqkv + Dq + 3 I) H bits / 8
// (1.41 GB at Llama-3.2-3B for 4 bits, 2.82 GB for 8), plus their bf16
// scales and the K/V history, over 3.35 TB/s. This first form pays 10-11
// grid barriers a layer and leaves most blocks idle in the row and
// attention phases, as kernel 12 does.

#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "w8a8_fused.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kPad = 144;          // staged bytes per 128 columns
constexpr int kGroupTB = 8;        // token rows staged at once
constexpr int kHeadBytes = 64;     // block reductions
constexpr int kSaBytes = 64;       // per-token scales of a staged group

// a staged activation row keeps each 128 columns in 144 bytes, so that the
// 16-byte reads of lanes 128 columns apart fall in different banks
__device__ __forceinline__ int padk(int k) { return (k >> 7) * kPad + (k & 127); }

// floats of one warp's group partials: 32 groups of up to V values, padded
template <int TB, int BITS>
__host__ __device__ constexpr int pf_floats() {
  return 32 * (2 * (BITS == 4 ? 2 : 1) * TB + 1);
}

// 4 bytes of 0..15 read as signed 4-bit fields
__device__ __forceinline__ int sext4(unsigned v) {
  return (int)(v | ((v & 0x08080808u) * 0x1Eu));
}

// the centred codes (q - 8) of 4 pair-nibble bytes: the high nibble is
// stored XOR 8, so its signed read is q - 8; the low nibble is q
__device__ __forceinline__ void nibbles(unsigned w, int& hi, int& lo) {
  hi = sext4((w >> 4) & 0x0F0F0F0Fu);
  lo = sext4((w ^ 0x08080808u) & 0x0F0F0F0Fu);
}

// The warp's NR packed rows (K bytes each, 16-byte aligned; K % gs == 0)
// against TB token rows of int8 activations staged in xs [TB][K] (padded,
// ``padk``). Value v = (r * F + f) * TB + b is row block f of packed row r
// (F = 2 nibble fields at 4 bits, the first row block in the high nibble
// where hi_first; F = 1 byte at 8 bits, stored XOR 128) against token row
// b. Lane g owns group g (gs columns, 32 groups a pass): the exact int32
// dot of the centred codes, times the group's scale ``scale(v, g)`` (one
// per (r, f)), plus, with ZP, the zero-point correction ``sz(v, g)``
// times the group's activation sum (kernel 14's fields_y: s z + sz S in
// float32), into the warp's partials pf; lane v < V then sums the groups
// in order. Returns lane v's sum. (ZP is a template argument so that the
// symmetric loop carries no activation sums.)
template <int TB, int BITS, int NR, bool ZP, typename Scale, typename Sz>
__device__ __forceinline__ float group_dot(const int8_t* const (&rows)[NR],
                                           int K, const int8_t* xs, int gs,
                                           bool hi_first, float* pf,
                                           Scale scale, Sz sz) {
  constexpr int F = BITS == 4 ? 2 : 1;
  constexpr int V = NR * F * TB;
  const int lane = threadIdx.x & 31;
  const int G = K / gs, n16 = gs / 16, xstride = (K >> 7) * kPad;
  float y = 0.f;
  for (int g0 = 0; g0 < G; g0 += 32) {
    const int g = g0 + lane;
    if (g < G) {
      float sg[NR * F], zg[NR * F];
#pragma unroll
      for (int u = 0; u < NR * F; ++u) {
        sg[u] = scale(u * TB, g);
        if constexpr (ZP) zg[u] = sz(u * TB, g);
      }
      int acc[V], xsum[TB];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0;
#pragma unroll
      for (int b = 0; b < TB; ++b) xsum[b] = 0;
#pragma unroll 2
      for (int c = 0; c < n16; ++c) {
        const int k = g * gs + 16 * c;
        int4 w[NR];
#pragma unroll
        for (int r = 0; r < NR; ++r)
          w[r] = __ldg(reinterpret_cast<const int4*>(rows[r] + k));
        const int kp = padk(k);
        int xw[TB][4];
#pragma unroll
        for (int b = 0; b < TB; ++b) {
          const int4 xv =
              *reinterpret_cast<const int4*>(xs + (size_t)b * xstride + kp);
          xw[b][0] = xv.x;
          xw[b][1] = xv.y;
          xw[b][2] = xv.z;
          xw[b][3] = xv.w;
        }
        if constexpr (ZP) {
#pragma unroll
          for (int b = 0; b < TB; ++b)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              xsum[b] = __dp4a(xw[b][j], 0x01010101, xsum[b]);
        }
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const int ww[4] = {w[r].x, w[r].y, w[r].z, w[r].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if constexpr (BITS == 8) {
#pragma unroll
              for (int b = 0; b < TB; ++b)
                acc[r * TB + b] = __dp4a(ww[j], xw[b][j], acc[r * TB + b]);
            } else {
              int hi, lo;
              nibbles((unsigned)ww[j], hi, lo);
              const int c0 = hi_first ? hi : lo, c1 = hi_first ? lo : hi;
#pragma unroll
              for (int b = 0; b < TB; ++b) {
                acc[2 * r * TB + b] =
                    __dp4a(c0, xw[b][j], acc[2 * r * TB + b]);
                acc[(2 * r + 1) * TB + b] =
                    __dp4a(c1, xw[b][j], acc[(2 * r + 1) * TB + b]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float p = __fmul_rn(sg[v / TB], (float)acc[v]);
        if constexpr (ZP)
          p = __fadd_rn(p, __fmul_rn(zg[v / TB], (float)xsum[v % TB]));
        pf[lane * (V + 1) + v] = p;
      }
    }
    __syncwarp();
    if (lane < V) {
      const int n = min(32, G - g0);
      for (int j = 0; j < n; ++j) y = __fadd_rn(y, pf[j * (V + 1) + lane]);
    }
    __syncwarp();
  }
  return y;
}

// group_dot with the zero-point corrections where szs is given; OPT (a
// kernel with optional operands) compiles that choice in at all, so that
// the symmetric kernels carry none of it
template <int TB, int BITS, int NR, bool OPT, typename Scale, typename Sz>
__device__ __forceinline__ float group_dot_zp(
    const int8_t* const (&rows)[NR], int K, const int8_t* xs, int gs,
    bool hi_first, float* pf, Scale scale, const float* szs, Sz sz) {
  if constexpr (OPT) {
    if (szs)
      return group_dot<TB, BITS, NR, true>(rows, K, xs, gs, hi_first, pf,
                                           scale, sz);
  }
  return group_dot<TB, BITS, NR, false>(rows, K, xs, gs, hi_first, pf, scale,
                                        sz);
}

// token rows b0 .. b0 + nb of src (row stride ld), columns k0 .. k0 + K,
// into xs [TB][K] padded (``padk``); rows past nb are zeros. Block-level,
// ends with a barrier.
template <int TB>
__device__ void stage_rows_ld(const int8_t* __restrict__ src, int ld, int k0,
                              int b0, int nb, int K, int8_t* xs) {
  const int n16 = K / 16, xstride = (K >> 7) * kPad;
  for (int e = threadIdx.x; e < TB * n16; e += kThreads) {
    const int b = e / n16, c = e - b * n16;
    int4 v = make_int4(0, 0, 0, 0);
    if (b < nb)
      v = *reinterpret_cast<const int4*>(src + (size_t)(b0 + b) * ld + k0 +
                                         16 * c);
    *reinterpret_cast<int4*>(xs + (size_t)b * xstride + padk(16 * c)) = v;
  }
  __syncthreads();
}

// as stage_rows_ld, with column k of the staged rows read from column
// perm[k] of src (kernel 14's act-order: the activations in the pack's
// group-sorted column order)
template <int TB>
__device__ void stage_rows_perm(const int8_t* __restrict__ src, int ld,
                                const int* __restrict__ perm, int b0, int nb,
                                int K, int8_t* xs) {
  const int xstride = (K >> 7) * kPad;
  for (int e = threadIdx.x; e < TB * K; e += kThreads) {
    const int b = e / K, k = e - b * K;
    xs[(size_t)b * xstride + padk(k)] =
        b < nb ? src[(size_t)(b0 + b) * ld + __ldg(perm + k)] : (int8_t)0;
  }
  __syncthreads();
}

// stage token rows b0 .. b0 + nb of the [B, K] activations src, in the
// column order perm where it is given (OPT: as group_dot_zp)
template <int TB, bool OPT>
__device__ __forceinline__ void stage_rows_ord(const int8_t* src,
                                               const int* perm, int b0,
                                               int nb, int K, int8_t* xs) {
  if constexpr (OPT) {
    if (perm) {
      stage_rows_perm<TB>(src, K, perm, b0, nb, K, xs);
      return;
    }
  }
  stage_rows_ld<TB>(src, K, 0, b0, nb, K, xs);
}

// the attention output's int8 scale of token row b: max(1e-12, max|a|) / 127
__device__ __forceinline__ float attn_scale(const W8A8Args& a, int b) {
  const int Hkv = a.kv_dim / a.d;
  float m = 1e-12f;
  for (int g = 0; g < Hkv; ++g) m = fmaxf(m, a.attn_amax[b * Hkv + g]);
  return m / 127.f;
}

__device__ __forceinline__ float bf(const bf16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// ------------------------------------------------------------ qkv + rope
// Packed qkv rows in rope pairs (rows of one pair share their 128-lane
// position, so the pairs of packed rows are the output rows' pairs in every
// row block); y = (sum_g s_g z_g) * sx + bias, rope with the partner read
// in float32 (kernel 14, lane rolls) or rounded to bf16 (kernel 13, sign
// permutation), out in bf16 to qkv_out and the layer's kn/vn.
template <int TB, int BITS, bool KMAJ, bool OPT>
__device__ void gphase_qkv(const W8A8Args& a, int l, int8_t* xs, float* pf) {
  constexpr int F = BITS == 4 ? 2 : 1;
  constexpr int FT = F * TB;
  const int H = a.H, Dqkv = a.q_dim + 2 * a.kv_dim, P = Dqkv / F;
  const int G = H / a.gs, tF = a.tq / F;
  const int n_rope = a.rd ? a.q_dim + a.kv_dim : 0;
  const int units = P / 2, nrb = (units + kWarps - 1) / kWarps;
  const int groups = (a.B + TB - 1) / TB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int8_t* pk = a.qkv_pk + (size_t)l * P * H;
  const bf16* sc = a.qkv_gs + (size_t)l * G * Dqkv;
  const float* bias = a.qkv_bias + (size_t)l * Dqkv;
  const float* szs = a.qkv_sz ? a.qkv_sz + (size_t)l * G * Dqkv : nullptr;
  const int* perm = a.ap_q ? a.ap_q + (size_t)l * H : nullptr;
  bf16* kn = a.kn + (size_t)l * a.B * a.kv_dim;
  bf16* vn = a.vn + (size_t)l * a.B * a.kv_dim;
  int staged = -1;
  for (int bu = blockIdx.x; bu < nrb * groups; bu += gridDim.x) {
    const int rb = bu / groups, grp = bu - rb * groups;
    const int b0 = grp * TB, nb = min(TB, a.B - b0);
    if (grp != staged) {
      __syncthreads();
      stage_rows_ord<TB, OPT>(a.x8, perm, b0, nb, H, xs);
      staged = grp;
    }
    const int u = rb * kWarps + warp;
    if (u >= units) continue;
    int p0, p1, ci;
    bool pair_rope;
    qkv_pair(u, 128, a.rd, a.interleaved, P, p0, p1, ci, pair_rope);
    auto row_of = [&](int v) {
      const int p = v < FT ? p0 : p1, f = (v / TB) % F;
      const int t = p / tF;
      return t * a.tq + f * tF + (p - t * tF);
    };
    const int8_t* rows[2] = {pk + (size_t)p0 * H, pk + (size_t)p1 * H};
    const float y = group_dot_zp<TB, BITS, 2, OPT>(
        rows, H, xs, a.gs, !KMAJ, pf,
        [&](int v, int g) { return bf(sc, (size_t)g * Dqkv + row_of(v)); },
        szs,
        [&](int v, int g) { return szs[(size_t)g * Dqkv + row_of(v)]; });
    const int b = lane % TB;
    const bool mine = lane < 2 * FT && b < nb;
    const int row = row_of(lane < 2 * FT ? lane : 0);
    float yv = 0.f;
    if (mine)
      yv = __fadd_rn(__fmul_rn(y, a.sx[b0 + b]), bias[row]);
    const float yp = __shfl_sync(0xffffffffu, yv,
                                 lane < FT ? lane + FT : lane - FT);
    if (!mine) continue;
    float out = yv;
    if (pair_rope && row < n_rope) {
      const float c = a.cos_half[(size_t)(b0 + b) * a.cos_ld + ci];
      const float sn = a.sin_half[(size_t)(b0 + b) * a.cos_ld + ci];
      const float pv = KMAJ ? bf16r(yp) : yp;
      out = __fadd_rn(__fmul_rn(yv, c), __fmul_rn(lane < FT ? -pv : pv, sn));
    }
    const bf16 o = __float2bfloat16(out);
    a.qkv_out[(size_t)(b0 + b) * Dqkv + row] = o;
    if (row >= a.q_dim + a.kv_dim)
      vn[(size_t)(b0 + b) * a.kv_dim + row - a.q_dim - a.kv_dim] = o;
    else if (row >= a.q_dim)
      kn[(size_t)(b0 + b) * a.kv_dim + row - a.q_dim] = o;
  }
}

// --------------------------------------------------------------- gate/up
// A warp per (gate, up) packed row pair of gu_pk [2 I / F, H] (gate tiles,
// then up tiles; tile-major scales gu_gs [G, 2 I]): act(g * sx) * (u * sx)
// into act_a [B, I] and max|a| per (token row, tile) into amax.
template <int TB, int BITS, bool KMAJ, bool OPT>
__device__ void gphase_gateup(const W8A8Args& a, int l, int8_t* xs, float* pf) {
  constexpr int F = BITS == 4 ? 2 : 1;
  constexpr int FT = F * TB;
  const int H = a.H, I = a.I, ti = a.ti, ng = I / ti, G = H / a.gs;
  const int tF = ti / F, PI = I / F;
  const int nrb = (PI + kWarps - 1) / kWarps;
  const int groups = (a.B + TB - 1) / TB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int8_t* pk = a.gu_pk + (size_t)l * 2 * PI * H;
  const bf16* sc = a.gu_gs + (size_t)l * G * 2 * I;
  const float* szs = a.gu_sz ? a.gu_sz + (size_t)l * G * 2 * I : nullptr;
  const int* perm = a.ap_g ? a.ap_g + (size_t)l * H : nullptr;
  int staged = -1;
  for (int bu = blockIdx.x; bu < nrb * groups; bu += gridDim.x) {
    const int rb = bu / groups, grp = bu - rb * groups;
    const int b0 = grp * TB, nb = min(TB, a.B - b0);
    if (grp != staged) {
      __syncthreads();
      stage_rows_ord<TB, OPT>(a.x8, perm, b0, nb, H, xs);
      staged = grp;
    }
    const int p = rb * kWarps + warp;
    if (p >= PI) continue;
    const int t = p / tF, i = p - t * tF;
    const int8_t* rows[2] = {pk + (size_t)p * H, pk + (size_t)(PI + p) * H};
    auto col = [&](int v) {
      const int r = v / FT, f = (v / TB) % F;
      return (size_t)(2 * t + r) * ti + f * tF + i;
    };
    const float y = group_dot_zp<TB, BITS, 2, OPT>(
        rows, H, xs, a.gs, !KMAJ, pf,
        [&](int v, int g) { return bf(sc, (size_t)g * 2 * I + col(v)); },
        szs,
        [&](int v, int g) { return szs[(size_t)g * 2 * I + col(v)]; });
    const float yu = __shfl_sync(0xffffffffu, y,
                                 lane < FT ? lane + FT : lane);
    const int b = lane % TB, f = (lane / TB) % F;
    if (lane >= FT || b >= nb) continue;
    const float sxb = a.sx[b0 + b];
    const float v = gated(__fmul_rn(y, sxb), __fmul_rn(yu, sxb), a.act);
    const int m = t * ti + f * tF + i;
    a.act_a[(size_t)(b0 + b) * I + m] = v;
    atomicMax(a.amax + (size_t)(b0 + b) * ng + t, __float_as_int(fabsf(v)));
  }
}

// ------------------------------------------- kernel 14: row-major o, down
// o_pk [H / F, q_dim]: a warp per two output rows (NR = 2 / F packed
// rows); x[b][n] += (sum_g s_g z_g) * sa[b] for the rows n it owns (a8
// staged from the quantized attention output).
template <int TB, int BITS, bool OPT>
__device__ void gphase_o_rows(const W8A8Args& a, int l, int8_t* xs,
                              float* sa_s, float* pf) {
  constexpr int F = BITS == 4 ? 2 : 1;
  constexpr int FT = F * TB, NR = 2 / F;
  const int H = a.H, K = a.q_dim, P = H / F, Gq = K / a.gs;
  const int units = P / NR, nrb = (units + kWarps - 1) / kWarps;
  const int groups = (a.B + TB - 1) / TB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int8_t* pk = a.o_pk + (size_t)l * P * K;
  const bf16* sc = a.o_gs + (size_t)l * Gq * H;
  const float* szs = a.o_sz ? a.o_sz + (size_t)l * Gq * H : nullptr;
  const int* perm = a.ap_o ? a.ap_o + (size_t)l * K : nullptr;
  int staged = -1;
  for (int bu = blockIdx.x; bu < nrb * groups; bu += gridDim.x) {
    const int rb = bu / groups, grp = bu - rb * groups;
    const int b0 = grp * TB, nb = min(TB, a.B - b0);
    if (grp != staged) {
      __syncthreads();
      if (threadIdx.x < TB)
        sa_s[threadIdx.x] =
            (int)threadIdx.x < nb ? attn_scale(a, b0 + threadIdx.x) : 1.f;
      stage_rows_ord<TB, OPT>(a.a8, perm, b0, nb, K, xs);
      staged = grp;
    }
    const int u = rb * kWarps + warp;
    if (u >= units) continue;
    auto row_of = [&](int v) { return ((v / TB) % F) * P + NR * u + v / FT; };
    const int8_t* rows[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) rows[r] = pk + (size_t)(NR * u + r) * K;
    const float y = group_dot_zp<TB, BITS, NR, OPT>(
        rows, K, xs, a.gs, true, pf,
        [&](int v, int g) { return bf(sc, (size_t)g * H + row_of(v)); },
        szs, [&](int v, int g) { return szs[(size_t)g * H + row_of(v)]; });
    const int b = lane % TB;
    if (lane >= 2 * TB || b >= nb) continue;
    float* xr = a.xs + (size_t)(b0 + b) * H + row_of(lane);
    *xr = __fadd_rn(*xr, __fmul_rn(y, sa_s[b]));
  }
}

// dn_pk [H / F, I]: a warp per two output rows walks the MLP tiles in
// order, ma += (sum over the tile's groups of s_g z_g) * sa_t, then adds ma
// to the residual rows it owns (a8 staged per tile from the quantized
// activation; dn_gs [NG * gtp, H], each tile's groups padded to gtp rows).
template <int TB, int BITS, bool OPT>
__device__ void gphase_down_rows(const W8A8Args& a, int l, int8_t* xs,
                                 float* sa_s, float* pf) {
  constexpr int F = BITS == 4 ? 2 : 1;
  constexpr int FT = F * TB, NR = 2 / F;
  const int H = a.H, I = a.I, ti = a.ti, ng = I / ti, P = H / F;
  const int units = P / NR, nrb = (units + kWarps - 1) / kWarps;
  const int groups = (a.B + TB - 1) / TB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int8_t* pk = a.dn_pk + (size_t)l * P * I;
  const bf16* sc = a.dn_gs + (size_t)l * ng * a.gtp * H;
  const float* szs = a.dn_sz ? a.dn_sz + (size_t)l * ng * a.gtp * H : nullptr;
  for (int bu = blockIdx.x; bu < nrb * groups; bu += gridDim.x) {
    const int rb = bu / groups, grp = bu - rb * groups;
    const int b0 = grp * TB, nb = min(TB, a.B - b0);
    const int u = rb * kWarps + warp;
    auto row_of = [&](int v) { return ((v / TB) % F) * P + NR * u + v / FT; };
    float ma = 0.f;
    for (int t = 0; t < ng; ++t) {
      __syncthreads();
      if (threadIdx.x < TB)
        sa_s[threadIdx.x] = (int)threadIdx.x < nb
                                ? tile_scale(a.amax, b0 + threadIdx.x, ng, t)
                                : 1.f;
      stage_rows_ld<TB>(a.a8, I, t * ti, b0, nb, ti, xs);
      if (u < units) {
        const int8_t* rows[NR];
#pragma unroll
        for (int r = 0; r < NR; ++r)
          rows[r] = pk + (size_t)(NR * u + r) * I + (size_t)t * ti;
        const float y = group_dot_zp<TB, BITS, NR, OPT>(
            rows, ti, xs, a.gs, true, pf,
            [&](int v, int g) {
              return bf(sc, (size_t)(t * a.gtp + g) * H + row_of(v));
            },
            szs, [&](int v, int g) {
              return szs[(size_t)(t * a.gtp + g) * H + row_of(v)];
            });
        if (lane < 2 * TB)
          ma = __fadd_rn(ma, __fmul_rn(y, sa_s[lane % TB]));
      }
    }
    const int b = lane % TB;
    if (u >= units || lane >= 2 * TB || b >= nb) continue;
    float* xr = a.xs + (size_t)(b0 + b) * H + row_of(lane);
    *xr = __fadd_rn(*xr, ma);
  }
}

// ------------------------------------------ kernel 13: K-major o, down
// partf [K / gs, B, N] = s_g[n] * z_g[b][n] for the K-major pair-column
// codes pk [K, N / 2] (byte column c holds output columns c and c + N / 2,
// the high nibble the second): a block per (group of gs rows, 1024 byte
// columns), a thread per 4 byte columns; a8 [B, lda] int8, B <= TB. srow(g):
// the group's bf16 scale row of N.
template <int TB, typename Srow>
__device__ void gphase_kmajor(const W8A8Args& a, const int8_t* pk, int K,
                              int N, int lda, int* a8w, Srow srow) {
  const int N2 = N / 2, gs = a.gs, gw = gs / 4;
  const int ngr = K / gs, nn = (N2 + kNCols - 1) / kNCols;
  for (int un = blockIdx.x; un < ngr * nn; un += gridDim.x) {
    const int g = un / nn, c0 = (un - g * nn) * kNCols + 4 * threadIdx.x;
    __syncthreads();
    for (int e = threadIdx.x; e < TB * gw; e += kThreads) {
      const int b = e / gw, w = e - b * gw;
      a8w[e] = b < a.B ? *reinterpret_cast<const int*>(
                             a.a8 + (size_t)b * lda + (size_t)g * gs + 4 * w)
                       : 0;
    }
    __syncthreads();
    if (c0 >= N2) continue;
    int acc[8][TB];
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int b = 0; b < TB; ++b) acc[c][b] = 0;
    const int8_t* base = pk + (size_t)g * gs * N2 + c0;
#pragma unroll 2
    for (int kk = 0; kk < gs; kk += 4) {
      const int8_t* p = base + (size_t)kk * N2;
      const unsigned w0 = __ldg(reinterpret_cast<const unsigned*>(p));
      const unsigned w1 = __ldg(reinterpret_cast<const unsigned*>(p + N2));
      const unsigned w2 = __ldg(reinterpret_cast<const unsigned*>(p + 2 * N2));
      const unsigned w3 = __ldg(reinterpret_cast<const unsigned*>(p + 3 * N2));
      // byte column c of the 4 x 4 bytes: rows kk .. kk + 3 in byte order
      const unsigned t0 = __byte_perm(w0, w1, 0x5140);
      const unsigned t1 = __byte_perm(w0, w1, 0x7362);
      const unsigned t2 = __byte_perm(w2, w3, 0x5140);
      const unsigned t3 = __byte_perm(w2, w3, 0x7362);
      const unsigned cw[4] = {__byte_perm(t0, t2, 0x5410),
                              __byte_perm(t0, t2, 0x7632),
                              __byte_perm(t1, t3, 0x5410),
                              __byte_perm(t1, t3, 0x7632)};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int hi, lo;
        nibbles(cw[c], hi, lo);
#pragma unroll
        for (int b = 0; b < TB; ++b) {
          const int av = a8w[b * gw + kk / 4];
          acc[c][b] = __dp4a(lo, av, acc[c][b]);
          acc[4 + c][b] = __dp4a(hi, av, acc[4 + c][b]);
        }
      }
    }
    const bf16* s = srow(g);
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      if (b >= a.B) break;
      float* out = a.partf + ((size_t)g * a.B + b) * N;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        out[c0 + c] = __fmul_rn(bf(s, c0 + c), (float)acc[c][b]);
        out[N2 + c0 + c] = __fmul_rn(bf(s, N2 + c0 + c), (float)acc[4 + c][b]);
      }
    }
  }
}

// kernel 13's residual of layer l's MLP into x, element e = (b, n):
// ma += (sum of the tile's group partials in order) * sa_t, tiles in order
__device__ __forceinline__ void kmajor_mlp_residual(const W8A8Args& a,
                                                    size_t e) {
  const int ng = a.I / a.ti, gti = a.ti / a.gs;
  const int b = (int)(e / a.H), n = (int)(e % a.H);
  float ma = 0.f;
  for (int t = 0; t < ng; ++t) {
    float y = 0.f;
    for (int j = 0; j < gti; ++j)
      y = __fadd_rn(y, a.partf[((size_t)(t * gti + j) * a.B + b) * a.H + n]);
    ma = __fadd_rn(ma, __fmul_rn(y, tile_scale(a.amax, b, ng, t)));
  }
  a.xs[e] = __fadd_rn(a.xs[e], ma);
}

// ----------------------------------------------------------------- kernel
template <int TB, int BITS, bool KMAJ, bool OPT>
__global__ void __launch_bounds__(kThreads, 2)
    grouped_megastep_kernel(W8A8Args a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  constexpr int kPf = pf_floats<TB, BITS>();
  float* pf = reinterpret_cast<float*>(smem + kHeadBytes) +
              (threadIdx.x >> 5) * kPf;
  unsigned char* work = smem + kHeadBytes + kWarps * kPf * sizeof(float);
  float* sa_s = reinterpret_cast<float*>(work);
  int8_t* xs_s = reinterpret_cast<int8_t*>(work + kSaBytes);
  const int H = a.H, I = a.I, ng = I / a.ti, Hkv = a.kv_dim / a.d;
  const size_t tid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t nthreads = (size_t)gridDim.x * kThreads;
  const size_t BH = (size_t)a.B * H;

  for (int l = 0; l < a.L; ++l) {
    // 0: layer entry
    for (size_t e = tid; e < BH; e += nthreads) {
      if (l == 0)
        a.xs[e] = static_cast<const float*>(a.x)[e];
      else if (KMAJ)
        kmajor_mlp_residual(a, e);
    }
    grid.sync();
    // 1: attention norm and int8 rows
    for (int b = blockIdx.x; b < a.B; b += gridDim.x)
      row_norm_quant<float>(a.xs + (size_t)b * H, H, H,
                            a.attn_norm + (size_t)l * H, a.eps, a.rms_offset,
                            a.x8 + (size_t)b * H, a.sx + b, red);
    grid.sync();
    // 2: qkv + rope; zero the MLP tile maxima
    for (size_t e = tid; e < (size_t)a.B * ng; e += nthreads) a.amax[e] = 0;
    gphase_qkv<TB, BITS, KMAJ, OPT>(a, l, xs_s, pf);
    grid.sync();
    // 3: attention
    for (int u = blockIdx.x; u < a.B * Hkv; u += gridDim.x) {
      const int b = u / Hkv, g = u - b * Hkv;
      const size_t off = (size_t)l * a.cache_sl + (size_t)b * a.cache_sb +
                         (size_t)g * a.cache_sg;
      attn_unit(a, b, g, a.qkv_out, a.k_cache + off, a.v_cache + off, a.attn,
                a.attn_amax, reinterpret_cast<float*>(work), a.pos[b]);
    }
    grid.sync();
    // 4: the attention output's int8 rows
    for (size_t e = tid; e < (size_t)a.B * a.q_dim; e += nthreads)
      a.a8[e] = (int8_t)quant8(a.attn[e], attn_scale(a, (int)(e / a.q_dim)));
    grid.sync();
    // 5: o
    if constexpr (KMAJ) {
      const int Gq = a.q_dim / a.gs;
      const bf16* os = a.o_gs + (size_t)l * Gq * H;
      gphase_kmajor<TB>(a, a.o_pk + (size_t)l * a.q_dim * (H / 2), a.q_dim,
                        H, a.q_dim, reinterpret_cast<int*>(work),
                        [&](int g) { return os + (size_t)g * H; });
      grid.sync();
      for (size_t e = tid; e < BH; e += nthreads) {
        const int b = (int)(e / H), n = (int)(e % H);
        float y = 0.f;
        for (int g = 0; g < Gq; ++g)
          y = __fadd_rn(y, a.partf[((size_t)g * a.B + b) * H + n]);
        a.xs[e] = __fadd_rn(a.xs[e], __fmul_rn(y, attn_scale(a, b)));
      }
    } else {
      gphase_o_rows<TB, BITS, OPT>(a, l, xs_s, sa_s, pf);
    }
    grid.sync();
    // 6: MLP norm and int8 rows
    for (int b = blockIdx.x; b < a.B; b += gridDim.x)
      row_norm_quant<float>(a.xs + (size_t)b * H, H, H,
                            a.mlp_norm + (size_t)l * H, a.eps, a.rms_offset,
                            a.x8 + (size_t)b * H, a.sx + b, red);
    grid.sync();
    // 7: gate/up
    gphase_gateup<TB, BITS, KMAJ, OPT>(a, l, xs_s, pf);
    grid.sync();
    // 8: the activation's int8 rows per tile
    for (size_t e = tid; e < (size_t)a.B * I; e += nthreads) {
      const int b = (int)(e / I), m = (int)(e % I);
      a.a8[e] = (int8_t)quant8(a.act_a[e], tile_scale(a.amax, b, ng, m / a.ti));
    }
    grid.sync();
    // 9: down
    if constexpr (KMAJ) {
      const bf16* ds = a.dn_gs + (size_t)l * ng * a.gtp * H;
      const int gti = a.ti / a.gs;
      gphase_kmajor<TB>(a, a.dn_pk + (size_t)l * I * (H / 2), I, H, I,
                        reinterpret_cast<int*>(work), [&](int g) {
                          return ds + (size_t)((g / gti) * a.gtp + g % gti) * H;
                        });
    } else {
      gphase_down_rows<TB, BITS, OPT>(a, l, xs_s, sa_s, pf);
    }
    grid.sync();
  }
  for (size_t e = tid; e < BH; e += nthreads) {
    if (KMAJ) kmajor_mlp_residual(a, e);
    static_cast<float*>(a.y)[e] = a.xs[e];
  }
}

template <int TB, int BITS, bool KMAJ, bool OPT>
cudaError_t launch_grouped(const W8A8Args& a, cudaStream_t s) {
  auto kernel = grouped_megastep_kernel<TB, BITS, KMAJ, OPT>;
  size_t kmax = (size_t)a.H;
  if (!KMAJ) kmax = (size_t)std::max(a.H, std::max(a.q_dim, a.ti));
  size_t work = sizeof(float) * kAttnSmemFloats;
  const size_t staged = kSaBytes + TB * ((kmax + 127) / 128) * kPad;
  if (staged > work) work = staged;
  if (KMAJ && (size_t)TB * a.gs > work) work = (size_t)TB * a.gs;
  const size_t smem = kHeadBytes +
                      kWarps * pf_floats<TB, BITS>() * sizeof(float) + work;
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

// OPT: the kernel that reads kernel 14's zero points and act-order orders
template <int BITS, bool KMAJ, bool OPT>
cudaError_t launch_grouped_b(const W8A8Args& a, cudaStream_t s) {
  if (a.B <= 1) return launch_grouped<1, BITS, KMAJ, OPT>(a, s);
  if (a.B <= 2) return launch_grouped<2, BITS, KMAJ, OPT>(a, s);
  if (a.B <= 4) return launch_grouped<4, BITS, KMAJ, OPT>(a, s);
  return launch_grouped<kGroupTB, BITS, KMAJ, OPT>(a, s);
}

}  // namespace
