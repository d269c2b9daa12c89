// Whole decode step over all layers in one launch, group-scaled uniform
// weights with int8 activations, for Hopper (sm_90a): the phases and the
// persistent kernel of kernel 13 (megastep4.cu, ganq_megastep4) and kernel
// 14 (megastep_lowbit.cu, ganq_megastep_lowbit, variants "w4p" and "w8p";
// with zero points or act-order megastep_lowbit_opt.cu; with the
// trailing-unembed fold megastep_lowbit_lm.cu and megastep_lowbit_lm_opt.cu;
// with the EoRA epilogue megastep_lowbit_lora*.cu; with the qk-norm and
// biases megastep_lowbit_arch*.cu; with gemma's operands
// megastep_lowbit_gemma.cu; "w3" and "w2" megastep_lowbit_w3w2.cu, with
// any optional operand megastep_lowbit_w3w2_ext.cu; "wl8", the Walsh LUT
// decode, megastep_lowbit_walsh.cu).
//
// Replaces ganq_tpu/ops/megastep4.py megastep4_decode (Pallas
// _megastep4_kernel) and ganq_tpu/ops/megastep_lowbit.py
// megastep_lowbit_decode (_megastep_lb_kernel, bits 8, 4, 3 and 2 and
// walsh=7; of its optional operands the zero points *_sz, the act-order
// orders ap_*, the trailing-unembed fold lm, the EoRA adapters la_* /
// lb_*, the qk-norm and bias operands and gemma's sandwich norms,
// windows, softcap and dual rope). The TPU kernels are one pallas_call walking
// (layers, phases) in order and dequantize by algebra on masked int8 MXU
// dots, because a TPU has no gather. Here a byte's codes are decoded by shift and mask: a
// pair-nibble byte holds the codes of two output rows (or, in kernel 13's
// K-major o and down, two output columns), and the warp that owns both
// decodes it once; at 3 and 2 bits a lane reads the 3 or 1 plane bytes of
// a packed unit and recovers the codes of its 8 or 4 row blocks
// (plane_fields). The numbers are the TPU kernels': per group of gs
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
// Kernel 14 with the EoRA epilogue (the LORA instantiations) adds, without a
// barrier of its own, the rank-r terms of the TPU kernel: phase 1 forms
// xa_q = xf . la_q^T from the normed float rows (xf before their int8
// rows), which phase 2 adds as xa_q . lb_q[row]^T after the qkv bias and
// before rope; phase 4 forms xa_o from the float attention output, which
// phase 5 adds with the o product before the residual; phase 6 forms xa_g,
// which phase 7 adds to gate and up before the activation; phase 8 forms
// xa_d = sum over the MLP tiles, in tile order, of a_t . la_d[:, t]^T from
// the float activation, which phase 9 adds with the down product. The A
// products are float32 dots (a block per 8 token rows and 4 ranks, its
// warps splitting the columns, 16-byte loads of A), the B products r
// float32 multiply-adds per output by the lane that owns it, reading lb_*
// in bf16.
//
// Kernel 14 with qwen3's qk-norm or o/gate-up/down biases (the ARCH
// instantiations, megastep_lowbit_arch*.cu) adds the TPU kernel's
// with_qkn and with_bias operands, each null where the pack has none: the
// biases by the lane that owns the output, where the TPU kernel adds them
// (o's and down's after their EoRA terms and before the residual, gate's
// and up's after theirs and before the activation); with qk_nm phase 2
// writes its float32 rows, bias and EoRA term added, to qkv_f instead of
// roping and storing them, and phase 3's block for (token row b, kv head g)
// first normalizes the heads it reads, its query heads, key head and value
// head (qk_norm_rope_heads: each head's mean square over its 128 lanes,
// the per-lane weight where qk_nm's mask is set), ropes and stores them in
// bf16: every head has one owner and the norm adds no grid barrier.
//
// Kernel 14 with gemma's operands (the GEMMA instantiation,
// megastep_lowbit_gemma.cu, which also takes every operand above, each run
// where it is set) adds the TPU kernel's with_sand, with_win, softcap and
// rope_sel: o's and down's products (bias and EoRA term added) go to the
// scratch sand instead of the residual, and a row pass (sandwich_row, a
// block per token row) norms them into it: the post-attention norm with
// the MLP norm of phase 6 (one more grid barrier only with the EoRA
// epilogue, whose A product reads every row), the post-MLP norm at the next
// layer's entry or, after the last layer, with y; phase 3 walks a sliding
// layer's keys from pos - window + 1 (none before it read) and caps the
// scaled scores; rope_table picks layer l's table of two.
//
// and after the last layer y = x. Kernel 14 with the trailing-unembed fold
// (the LM instantiations) then runs, after a barrier each, the final norm
// and int8 rows (row_norm_quant with the final norm's weight: the rounding
// of the TPU kernel's _quant_rows) and the vocab phase, a warp per two
// int8 lm_head rows writing float32 logits. The residual stays float32 in device
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
// (1.41 GB at Llama-3.2-3B for 4 bits, 2.82 GB for 8, 1.06 for 3 and the
// Walsh planes, 0.70 for 2), plus their bf16 (Walsh: float32 coefficient)
// scales, the K/V history and, with EoRA, the bf16 factors (161 MB at 3B
// and r = 64), over 3.35 TB/s. This first form pays 10-11
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

// kernel 14's "wl8" (the Walsh LUT decode) as a BITS value: 3 stored bit
// planes, 7 monomial planes
constexpr int kWalsh = 7;

// output rows of one packed unit (a byte position of its planes): 2 at 4
// bits, 8 at 3 (and in the Walsh planes), 4 at 2, 1 at 8
template <int BITS>
__host__ __device__ constexpr int fields() {
  return BITS == 4 ? 2 : (BITS == 3 || BITS == kWalsh) ? 8 : BITS == 2 ? 4 : 1;
}

// plane bytes of one packed unit, each plane tF rows after the last
template <int BITS>
__host__ __device__ constexpr int planes() {
  return (BITS == 3 || BITS == kWalsh) ? 3 : 1;
}

// token rows a staged group: a warp's values (packed rows x fields x token
// rows) must fit its 32 lanes, so 3 bits take 2 and 2 bits 4
template <int BITS>
__host__ __device__ constexpr int max_tb() {
  return BITS == 3 ? 2 : BITS == 2 ? 4 : 8;
}

// floats of one warp's group partials: 32 groups of up to V values, padded
// (the Walsh walks: its 32 lanes' 32 integer dots, ``walsh_dots_block``)
template <int TB, int BITS>
__host__ __device__ constexpr int pf_floats() {
  return BITS == kWalsh ? 1024 : 32 * (2 * fields<BITS>() * TB + 1);
}

// the packed row of unit p (tile t = p / tF, row i in its block) in
// tile-major planes: t * NP * tF + i, its planes tF rows apart
template <int BITS>
__device__ __forceinline__ int unit_row(int p, int tF) {
  if constexpr (planes<BITS>() == 1) return p;
  else return (p / tF) * planes<BITS>() * tF + p % tF;
}

// the g_r codes (0 .. 2^bits - 1, one a byte) of 4 columns of a 3- or 2-bit
// unit from its plane words pw (``_PLAN``; the top field of every plane is
// stored XOR its sign bit, byte bit 7, and rows 2 and 5 of the 3-bit plan
// are split across two planes, joined as hi << shift | lo)
template <int BITS>
__device__ __forceinline__ void plane_fields(const unsigned (&pw)[planes<BITS>()],
                                             unsigned (&c)[fields<BITS>()]) {
  constexpr unsigned m1 = 0x01010101u, m2 = 0x03030303u, m3 = 0x07070707u;
  if constexpr (BITS == 3) {
    const unsigned a = pw[0] ^ 0x80808080u, b = pw[1] ^ 0x80808080u,
                   d = pw[2] ^ 0x80808080u;
    c[0] = (a >> 5) & m3;
    c[1] = (a >> 2) & m3;
    c[2] = ((a & m2) << 1) | ((b >> 7) & m1);
    c[3] = (b >> 4) & m3;
    c[4] = (b >> 1) & m3;
    c[5] = ((b & m1) << 2) | ((d >> 6) & m2);
    c[6] = (d >> 3) & m3;
    c[7] = d & m3;
  } else {
    const unsigned a = pw[0] ^ 0x80808080u;
    c[0] = (a >> 6) & m2;
    c[1] = (a >> 4) & m2;
    c[2] = (a >> 2) & m2;
    c[3] = a & m2;
  }
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
// where hi_first; F = 1 byte at 8 bits, stored XOR 128; at 3 and 2 bits
// the unit's NP plane rows, pstride bytes apart, hold F = 8 or 4 fields,
// ``plane_fields``) against token row b. Lane g owns group g (gs columns,
// 32 groups a pass): the exact int32 dot of the centred codes (at 3 and 2
// bits the codes' dot less 2^(bits-1) times the activation sum), times
// the group's scale ``scale(v, g)`` (one per (r, f)), plus, with ZP, the
// zero-point correction ``sz(v, g)`` times the group's activation sum
// (kernel 14's fields_y: s z + sz S in float32), into the warp's partials
// pf; lane v < V then sums the groups in order. Returns lane v's sum. (ZP
// is a template argument so that the symmetric loop carries no activation
// sums.)
template <int TB, int BITS, int NR, bool ZP, typename Scale, typename Sz>
__device__ __forceinline__ float group_dot(const int8_t* const (&rows)[NR],
                                           int K, const int8_t* xs, int gs,
                                           bool hi_first, float* pf,
                                           Scale scale, Sz sz,
                                           size_t pstride = 0) {
  constexpr int F = fields<BITS>();
  constexpr int V = NR * F * TB;
  constexpr bool LOW = BITS == 3 || BITS == 2;    // codes, then centred
  constexpr int NP = planes<BITS>();
  static_assert(V <= 32, "a lane per value");
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
        int4 w[NR * NP];
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          if constexpr (LOW) {
#pragma unroll
            for (int p = 0; p < NP; ++p)
              w[r * NP + p] = __ldg(reinterpret_cast<const int4*>(
                  rows[r] + p * pstride + k));
          } else {
            w[r] = __ldg(reinterpret_cast<const int4*>(rows[r] + k));
          }
        }
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
        if constexpr (ZP || LOW) {
#pragma unroll
          for (int b = 0; b < TB; ++b)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              xsum[b] = __dp4a(xw[b][j], 0x01010101, xsum[b]);
        }
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          if constexpr (LOW) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              unsigned pw[NP], cf[F];
#pragma unroll
              for (int p = 0; p < NP; ++p) {
                const int4 q = w[r * NP + p];
                pw[p] = (unsigned)(j == 0 ? q.x : j == 1 ? q.y : j == 2 ? q.z
                                                                        : q.w);
              }
              plane_fields<BITS>(pw, cf);
#pragma unroll
              for (int f = 0; f < F; ++f)
#pragma unroll
                for (int b = 0; b < TB; ++b)
                  acc[(r * F + f) * TB + b] =
                      __dp4a((int)cf[f], xw[b][j], acc[(r * F + f) * TB + b]);
            }
          } else {
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
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if constexpr (LOW) acc[v] -= (1 << (BITS - 1)) * xsum[v % TB];
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
    bool hi_first, float* pf, Scale scale, const float* szs, Sz sz,
    size_t pstride = 0) {
  if constexpr (OPT) {
    if (szs)
      return group_dot<TB, BITS, NR, true>(rows, K, xs, gs, hi_first, pf,
                                           scale, sz, pstride);
  }
  return group_dot<TB, BITS, NR, false>(rows, K, xs, gs, hi_first, pf, scale,
                                        sz, pstride);
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

// the attention output's int8 scale of token row b: max(1e-12, max|a|) *
// fl(1/127) (sa_of)
__device__ __forceinline__ float attn_scale(const W8A8Args& a, int b) {
  const int Hkv = a.kv_dim / a.d;
  float m = 1e-12f;
  for (int g = 0; g < Hkv; ++g) m = fmaxf(m, a.attn_amax[b * Hkv + g]);
  return sa_of(m);
}

__device__ __forceinline__ float bf(const bf16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// Whether the EoRA epilogue (LORA) and the trailing-unembed fold (LM) run:
// compiled in or out by their flags, except in the GEMMA instantiation,
// which carries both and runs each where its operands are set
template <bool LORA, bool GEMMA>
__device__ __forceinline__ bool lora_on(const W8A8Args& a) {
  if constexpr (!LORA) return false;
  else if constexpr (GEMMA) return a.la_q != nullptr;
  else return true;
}

template <bool LM, bool GEMMA>
__device__ __forceinline__ bool lm_on(const W8A8Args& a) {
  if constexpr (!LM) return false;
  else if constexpr (GEMMA) return a.lm_w8 != nullptr;
  else return true;
}

// Layer l's rope table t (cos or sin): with gemma3's dual rope (GEMMA,
// rope_sel set) the second of the two [B, cos_ld] tables where
// rope_sel[l] is 1
template <bool GEMMA>
__device__ __forceinline__ const float* rope_table(const W8A8Args& a,
                                                   const float* t, int l) {
  if constexpr (GEMMA) {
    if (a.rope_sel && a.rope_sel[l]) return t + (size_t)a.B * a.cos_ld;
  }
  return t;
}

// Gemma's sandwich norm of token row b (a block): the float32 sublayer
// output u = sand[b] (o's or down's, bias and EoRA term added) normed,
// u * rsqrt(mean(u^2) + eps) * (w + rms_offset), and added to the residual
// row; y (null: none) receives the new row too. Ends with a block barrier.
__device__ void sandwich_row(const W8A8Args& a, int b, const float* w,
                             float* y, float* red) {
  const int H = a.H;
  const float* u = a.sand + (size_t)b * H;
  float* xr = a.xs + (size_t)b * H;
  float ss = 0.f;
  for (int k = threadIdx.x; k < H; k += kThreads) ss += u[k] * u[k];
  const float r = rsqrtf(block_sum(ss, red) / (float)H + a.eps);
  for (int k = threadIdx.x; k < H; k += kThreads) {
    const float x = __fadd_rn(
        xr[k], __fmul_rn(__fmul_rn(u[k], r), w[k] + a.rms_offset));
    xr[k] = x;
    if (y) y[(size_t)b * H + k] = x;
  }
  __syncthreads();
}

// ------------------------------------------------ kernel 14: EoRA epilogue
constexpr int kLoraR = 4;          // ranks of one lora_xa unit
static_assert(kLoraR * kWarps == 32, "a lane per (rank, row) slot");

// The A products of the rank-r epilogue (the TPU kernel's _lora_dot into
// xaq_s, xao, xag_s and xad_s): xa[b][j] = sum_k v_b(k) la[j][k] for token
// rows b < B and ranks j < r, la [r, K] bf16 in the pack's column order.
// v_b(k) = src[b][perm[k]] (perm null: k) and, with a norm weight nw, times
// nw[perm[k]] + offset and the row's rms scale: the normed float activation
// before its int8 rows (the scale, one per row, multiplies the finished
// dot). The K columns are summed tile by tile (``tile`` columns each:
// down's MLP tiles, K otherwise) and the tiles' sums added in tile order, as
// the TPU kernel accumulates down's over its tile walk. A block per (group
// of kWarps token rows, kLoraR ranks); its warps split each tile's columns,
// 8 a lane and step in 16-byte loads, and their partial sums meet in shared
// memory, where warp 0 adds them in warp order and the tiles in tile order.
// The dependent chain is a few steps per warp, where one warp walking all K
// columns was latency bound. One owner per output, no atomics: nothing
// depends on the blocks' order. red: kWarps * kWarps * (kLoraR + 1) floats
// of shared memory.
__device__ void lora_xa(const W8A8Args& a, const float* src, int K, int tile,
                        const int* __restrict__ perm,
                        const float* __restrict__ nw,
                        const bf16* __restrict__ la, int r, float* xa,
                        float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int groups = (a.B + kWarps - 1) / kWarps;
  const int chunks = (r + kLoraR - 1) / kLoraR;
  const int cw = tile / kWarps;                 // a warp's columns a tile
  constexpr int kSlots = kLoraR * kWarps;       // (rank, row) sums a unit
  float* part = red;                            // [kWarps][kSlots]
  float* psq = red + kWarps * kSlots;           // [kWarps][kWarps]
  for (int u = blockIdx.x; u < groups * chunks; u += gridDim.x) {
    const int grp = u / chunks, ch = u - grp * chunks;
    const int b0 = grp * kWarps, nb = min(kWarps, a.B - b0);
    const int j0 = ch * kLoraR, nr = min(kLoraR, r - j0);
    float tot = 0.f, sqt = 0.f;   // warp 0: slot lane, and row lane's squares
    for (int t0 = 0; t0 < K; t0 += tile) {
      float acc[kLoraR][kWarps], sq[kWarps];
#pragma unroll
      for (int b = 0; b < kWarps; ++b) {
        sq[b] = 0.f;
#pragma unroll
        for (int i = 0; i < kLoraR; ++i) acc[i][b] = 0.f;
      }
      const int c0 = t0 + warp * cw;
      for (int k = c0 + lane * 8; k < c0 + cw; k += 256) {
        float w[kLoraR][8];
#pragma unroll
        for (int i = 0; i < kLoraR; ++i) {
          const uint4 raw = i < nr ? __ldg(reinterpret_cast<const uint4*>(
                                         la + (size_t)(j0 + i) * K + k))
                                   : make_uint4(0, 0, 0, 0);
          bf16x4(make_uint2(raw.x, raw.y), w[i]);
          bf16x4(make_uint2(raw.z, raw.w), w[i] + 4);
        }
        int pk[8];
        float g[8];
        if (perm) {
          const int4 p0 = __ldg(reinterpret_cast<const int4*>(perm + k));
          const int4 p1 = __ldg(reinterpret_cast<const int4*>(perm + k + 4));
          pk[0] = p0.x, pk[1] = p0.y, pk[2] = p0.z, pk[3] = p0.w;
          pk[4] = p1.x, pk[5] = p1.y, pk[6] = p1.z, pk[7] = p1.w;
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) pk[e] = k + e;
        }
        if (nw) {
#pragma unroll
          for (int e = 0; e < 8; ++e) g[e] = __ldg(nw + pk[e]) + a.rms_offset;
        }
#pragma unroll
        for (int b = 0; b < kWarps; ++b) {
          if (b >= nb) break;
          const float* xr = src + (size_t)(b0 + b) * K;
          float v[8];
          if (perm) {
#pragma unroll
            for (int e = 0; e < 8; ++e) v[e] = xr[pk[e]];
          } else {
            const float4 x0 = *reinterpret_cast<const float4*>(xr + k);
            const float4 x1 = *reinterpret_cast<const float4*>(xr + k + 4);
            v[0] = x0.x, v[1] = x0.y, v[2] = x0.z, v[3] = x0.w;
            v[4] = x1.x, v[5] = x1.y, v[6] = x1.z, v[7] = x1.w;
          }
          if (nw) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              sq[b] = fmaf(v[e], v[e], sq[b]);
              v[e] = __fmul_rn(v[e], g[e]);
            }
          }
#pragma unroll
          for (int i = 0; i < kLoraR; ++i) {
            float t = acc[i][b];
#pragma unroll
            for (int e = 0; e < 8; ++e) t = fmaf(v[e], w[i][e], t);
            acc[i][b] = t;
          }
        }
      }
      // the warps' partial sums of this tile, then (warp 0) their sum in
      // warp order, added to the running total in tile order
#pragma unroll
      for (int b = 0; b < kWarps; ++b) {
        if (b >= nb) break;
#pragma unroll
        for (int i = 0; i < kLoraR; ++i) {
          const float s = warp_sum(acc[i][b]);
          if (lane == 0) part[warp * kSlots + i * kWarps + b] = s;
        }
        if (nw) {
          const float s = warp_sum(sq[b]);
          if (lane == 0) psq[warp * kWarps + b] = s;
        }
      }
      __syncthreads();
      if (warp == 0) {
        float s = 0.f;
        for (int w_ = 0; w_ < kWarps; ++w_)
          s = __fadd_rn(s, part[w_ * kSlots + lane]);
        tot = __fadd_rn(tot, s);
        if (nw && lane < kWarps) {
          float q = 0.f;
          for (int w_ = 0; w_ < kWarps; ++w_) q += psq[w_ * kWarps + lane];
          sqt += q;
        }
      }
      __syncthreads();
    }
    if (warp == 0) {
      const int i = lane / kWarps, b = lane - i * kWarps;   // slot lane
      float x = tot;
      if (nw) {
        const float ss = __shfl_sync(0xffffffffu, sqt, b);
        x = __fmul_rn(x, rsqrtf(ss / (float)K + a.eps));
      }
      if (i < nr && b < nb) xa[(size_t)(b0 + b) * r + j0 + i] = x;
    }
  }
}

// The B product of one output row: sum_j xa[j] lb[j] over the r ranks (xa
// float32, lb bf16; 16-byte loads where r is a multiple of 8)
__device__ __forceinline__ float lora_b(const float* xa,
                                        const bf16* __restrict__ lb, int r) {
  float s = 0.f;
  if ((r & 7) == 0) {
#pragma unroll 4
    for (int j = 0; j < r; j += 8) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(lb + j));
      float w[8];
      bf16x4(make_uint2(raw.x, raw.y), w);
      bf16x4(make_uint2(raw.z, raw.w), w + 4);
      const float4 x0 = *reinterpret_cast<const float4*>(xa + j);
      const float4 x1 = *reinterpret_cast<const float4*>(xa + j + 4);
      s = fmaf(x0.x, w[0], s);
      s = fmaf(x0.y, w[1], s);
      s = fmaf(x0.z, w[2], s);
      s = fmaf(x0.w, w[3], s);
      s = fmaf(x1.x, w[4], s);
      s = fmaf(x1.y, w[5], s);
      s = fmaf(x1.z, w[6], s);
      s = fmaf(x1.w, w[7], s);
    }
    return s;
  }
  for (int j = 0; j < r; ++j) s = fmaf(xa[j], bf(lb, j), s);
  return s;
}

// The B products of the warp's V outputs (output v owned by lane v, V <=
// 32): out_v = lora_b(xa_of(v), lb_of(v), r), 0 where xa_of(v) is null
template <int V, typename XaOf, typename LbOf>
__device__ __forceinline__ float lora_out(int r, XaOf xa_of, LbOf lb_of) {
  const int lane = threadIdx.x & 31;
  const float* xv = lane < V ? xa_of(lane) : nullptr;
  return xv ? lora_b(xv, lb_of(lane), r) : 0.f;
}

// ------------------------------------------------------------ qkv + rope
// Packed qkv rows in rope pairs (rows of one pair share their 128-lane
// position, so the pairs of packed rows are the output rows' pairs in every
// row block); y = (sum_g s_g z_g) * sx + bias, rope with the partner read
// in float32 (kernel 14, lane rolls) or rounded to bf16 (kernel 13, sign
// permutation), out in bf16 to qkv_out and the layer's kn/vn. LORA adds
// xa_q . lb_q[row]^T after the bias; GEMMA reads layer l's rope table
// (``rope_table``).
template <int TB, int BITS, bool KMAJ, bool OPT, bool LORA, bool ARCH,
          bool GEMMA = false>
__device__ void gphase_qkv(const W8A8Args& a, int l, int8_t* xs, float* pf) {
  constexpr int F = fields<BITS>(), NP = planes<BITS>();
  constexpr int FT = F * TB;
  const int H = a.H, Dqkv = a.q_dim + 2 * a.kv_dim, P = Dqkv / F;
  const int G = H / a.gs, tF = a.tq / F;
  const int n_rope = a.rd ? a.q_dim + a.kv_dim : 0;
  const int units = P / 2, nrb = (units + kWarps - 1) / kWarps;
  const int groups = (a.B + TB - 1) / TB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int8_t* pk = a.qkv_pk + (size_t)l * NP * P * H;
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
    const int8_t* rows[2] = {pk + (size_t)unit_row<BITS>(p0, tF) * H,
                             pk + (size_t)unit_row<BITS>(p1, tF) * H};
    const float y = group_dot_zp<TB, BITS, 2, OPT>(
        rows, H, xs, a.gs, !KMAJ, pf,
        [&](int v, int g) { return bf(sc, (size_t)g * Dqkv + row_of(v)); },
        szs,
        [&](int v, int g) { return szs[(size_t)g * Dqkv + row_of(v)]; },
        (size_t)tF * H);
    float lora = 0.f;
    const bool with_lora = lora_on<LORA, GEMMA>(a);
    if (with_lora)
      lora = lora_out<2 * FT>(
          a.r_q,
          [&](int v) {
            return v % TB < nb ? a.xa_q + (size_t)(b0 + v % TB) * a.r_q
                               : nullptr;
          },
          [&](int v) {
            return a.lb_q + ((size_t)l * Dqkv + row_of(v)) * a.r_q;
          });
    const int b = lane % TB;
    const bool mine = lane < 2 * FT && b < nb;
    const int row = row_of(lane < 2 * FT ? lane : 0);
    float yv = 0.f;
    if (mine) {
      yv = __fadd_rn(__fmul_rn(y, a.sx[b0 + b]), bias[row]);
      if (with_lora) yv = __fadd_rn(yv, lora);
    }
    const float yp = __shfl_sync(0xffffffffu, yv,
                                 lane < FT ? lane + FT : lane - FT);
    if (!mine) continue;
    if constexpr (ARCH) {
      if (a.qk_nm) {       // normed, roped and stored in phase 3
        a.qkv_f[(size_t)(b0 + b) * Dqkv + row] = yv;
        continue;
      }
    }
    float out = yv;
    if (pair_rope && row < n_rope) {
      const float c =
          rope_table<GEMMA>(a, a.cos_half, l)[(size_t)(b0 + b) * a.cos_ld + ci];
      const float sn =
          rope_table<GEMMA>(a, a.sin_half, l)[(size_t)(b0 + b) * a.cos_ld + ci];
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

// Kernel 14's qk-norm (ARCH with qk_nm) for token row b and kv head g: the
// heads that phase 3's unit (b, g) reads, its qpk query heads, key head and
// value head, from the float32 pre-rope rows qkv_f. A warp per head: each
// lane holds 4 of its 128 lanes, their squares summed and then summed over
// the warp (the mean square), y * (rsqrt(msq + eps) * (w + rms_offset))
// where qk_nm's mask row is set (w its weight row), rope with the partner
// lane in float32 as gphase_qkv's, bf16 into qkv_out and the layer's kn /
// vn (GEMMA: layer l's rope table, ``rope_table``). sh: kWarps * 128
// floats. Ends with a block barrier.
template <bool GEMMA = false>
__device__ void qk_norm_rope_heads(const W8A8Args& a, int l, int b, int g,
                                   float* sh) {
  constexpr int d = 128;
  const int Hkv = a.kv_dim / d, Hq = a.q_dim / d, qpk = Hq / Hkv;
  const int Dqkv = a.q_dim + 2 * a.kv_dim, rh = a.rd >> 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* w = a.qk_nm + (size_t)l * 2 * Dqkv;
  const float* m = w + Dqkv;
  const float* yrow = a.qkv_f + (size_t)b * Dqkv;
  bf16* kn = a.kn + ((size_t)l * a.B + b) * a.kv_dim;
  bf16* vn = a.vn + ((size_t)l * a.B + b) * a.kv_dim;
  float* hs = sh + warp * d;
  for (int j = warp; j < qpk + 2; j += kWarps) {
    const int head = j < qpk ? g * qpk + j : (j == qpk ? Hq + g : Hq + Hkv + g);
    const int base = head * d;
    float y[4], ss = 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      y[c] = yrow[base + lane + 32 * c];
      ss = fmaf(y[c], y[c], ss);
    }
    const float r = rsqrtf(__fmul_rn(warp_sum(ss), 1.f / d) + a.eps);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = base + lane + 32 * c;
      if (m[i] != 0.f)
        y[c] = __fmul_rn(y[c], __fmul_rn(r, w[i] + a.rms_offset));
      hs[lane + 32 * c] = y[c];
    }
    __syncwarp();
    const bool roped = a.rd && base < a.q_dim + a.kv_dim;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int k = lane + 32 * c;
      float out = y[c];
      if (roped && k < a.rd) {
        int ci, p;
        bool first;
        if (a.interleaved) {
          ci = k >> 1, p = k ^ 1, first = !(k & 1);
        } else {
          first = k < rh, ci = first ? k : k - rh, p = first ? k + rh : k - rh;
        }
        const float cv =
            rope_table<GEMMA>(a, a.cos_half, l)[(size_t)b * a.cos_ld + ci];
        const float sv =
            rope_table<GEMMA>(a, a.sin_half, l)[(size_t)b * a.cos_ld + ci];
        out = __fadd_rn(__fmul_rn(y[c], cv),
                        __fmul_rn(first ? -hs[p] : hs[p], sv));
      }
      const bf16 o = __float2bfloat16(out);
      a.qkv_out[(size_t)b * Dqkv + base + k] = o;
      if (base >= a.q_dim + a.kv_dim)
        vn[base - a.q_dim - a.kv_dim + k] = o;
      else if (base >= a.q_dim)
        kn[base - a.q_dim + k] = o;
    }
    __syncwarp();
  }
  __syncthreads();
}

// --------------------------------------------------------------- gate/up
// A warp per (gate, up) packed row pair of gu_pk [2 I / F, H] (gate tiles,
// then up tiles; tile-major scales gu_gs [G, 2 I]): act(g * sx) * (u * sx)
// into act_a [B, I] and max|a| per (token row, tile) into amax. LORA adds
// xa_g . lb_g[row]^T to gate and up before the activation (lb_g's rows
// tile-major like the scales' columns).
template <int TB, int BITS, bool KMAJ, bool OPT, bool LORA, bool ARCH,
          bool GEMMA = false>
__device__ void gphase_gateup(const W8A8Args& a, int l, int8_t* xs, float* pf) {
  constexpr int F = fields<BITS>(), NP = planes<BITS>();
  constexpr int FT = F * TB;
  const int H = a.H, I = a.I, ti = a.ti, ng = I / ti, G = H / a.gs;
  const int tF = ti / F, PI = I / F;
  const int nrb = (PI + kWarps - 1) / kWarps;
  const int groups = (a.B + TB - 1) / TB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int8_t* pk = a.gu_pk + (size_t)l * 2 * NP * PI * H;
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
    const int8_t* rows[2] = {
        pk + (size_t)unit_row<BITS>(p, tF) * H,
        pk + (size_t)(NP * PI + unit_row<BITS>(p, tF)) * H};
    auto col = [&](int v) {
      const int r = v / FT, f = (v / TB) % F;
      return (size_t)(2 * t + r) * ti + f * tF + i;
    };
    const float y = group_dot_zp<TB, BITS, 2, OPT>(
        rows, H, xs, a.gs, !KMAJ, pf,
        [&](int v, int g) { return bf(sc, (size_t)g * 2 * I + col(v)); },
        szs,
        [&](int v, int g) { return szs[(size_t)g * 2 * I + col(v)]; },
        (size_t)tF * H);
    const int b = lane % TB, f = (lane / TB) % F;
    float v;
    if constexpr (LORA || ARCH) {
      // gate (lanes < FT) and up (FT .. 2 FT) each add their rank-r term
      // (LORA) and bias (ARCH) to y * sx, then the up value goes to its
      // gate lane
      float lora = 0.f;
      const bool with_lora = lora_on<LORA, GEMMA>(a);
      if (with_lora)
        lora = lora_out<2 * FT>(
            a.r_g,
            [&](int w) {
              return w % TB < nb ? a.xa_g + (size_t)(b0 + w % TB) * a.r_g
                                 : nullptr;
            },
            [&](int w) {
              return a.lb_g + ((size_t)l * 2 * I + col(w)) * a.r_g;
            });
      const bool ok = lane < 2 * FT && b < nb;
      float yy = 0.f;
      if (ok) {
        yy = __fmul_rn(y, a.sx[b0 + b]);
        if (with_lora) yy = __fadd_rn(yy, lora);
        if constexpr (ARCH) {
          if (a.gu_bias)
            yy = __fadd_rn(yy, a.gu_bias[(size_t)l * 2 * I + col(lane)]);
        }
      }
      const float yu = __shfl_sync(0xffffffffu, yy,
                                   lane < FT ? lane + FT : lane);
      if (lane >= FT || b >= nb) continue;
      v = gated(yy, yu, a.act);
    } else {
      const float yu = __shfl_sync(0xffffffffu, y,
                                   lane < FT ? lane + FT : lane);
      if (lane >= FT || b >= nb) continue;
      const float sxb = a.sx[b0 + b];
      v = gated(__fmul_rn(y, sxb), __fmul_rn(yu, sxb), a.act);
    }
    const int m = t * ti + f * tF + i;
    a.act_a[(size_t)(b0 + b) * I + m] = v;
    atomicMax(a.amax + (size_t)(b0 + b) * ng + t, __float_as_int(fabsf(v)));
  }
}

// ------------------------------------------- kernel 14: row-major o, down
// o_pk [NP H / F, q_dim]: a warp per two output rows at 8 and 4 bits (NR =
// 2 / F packed rows), per packed unit (F rows) at 3 and 2; x[b][n] +=
// (sum_g s_g z_g) * sa[b] for the rows n it owns (a8
// staged from the quantized attention output). LORA adds xa_o . lb_o[n]^T
// to the product before the residual. GEMMA with sandwich norms writes the
// product (bias and EoRA term added) to sand instead, for the norm pass.
template <int TB, int BITS, bool OPT, bool LORA, bool ARCH,
          bool GEMMA = false>
__device__ void gphase_o_rows(const W8A8Args& a, int l, int8_t* xs,
                              float* sa_s, float* pf) {
  constexpr int F = fields<BITS>(), NP = planes<BITS>();
  constexpr int FT = F * TB, NR = F == 1 ? 2 : 1, VO = NR * FT;
  const int H = a.H, K = a.q_dim, P = H / F, Gq = K / a.gs;
  const int units = P / NR, nrb = (units + kWarps - 1) / kWarps;
  const int groups = (a.B + TB - 1) / TB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int8_t* pk = a.o_pk + (size_t)l * NP * P * K;
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
        szs, [&](int v, int g) { return szs[(size_t)g * H + row_of(v)]; },
        (size_t)P * K);
    float lora = 0.f;
    const bool with_lora = lora_on<LORA, GEMMA>(a);
    if (with_lora)
      lora = lora_out<VO>(
          a.r_o,
          [&](int v) {
            return v % TB < nb ? a.xa_o + (size_t)(b0 + v % TB) * a.r_o
                               : nullptr;
          },
          [&](int v) { return a.lb_o + ((size_t)l * H + row_of(v)) * a.r_o; });
    const int b = lane % TB;
    if (lane >= VO || b >= nb) continue;
    float upd = __fmul_rn(y, sa_s[b]);
    if (with_lora) upd = __fadd_rn(upd, lora);
    if constexpr (ARCH) {
      if (a.o_bias)
        upd = __fadd_rn(upd, a.o_bias[(size_t)l * H + row_of(lane)]);
    }
    if constexpr (GEMMA) {
      if (a.pa_norm) {
        a.sand[(size_t)(b0 + b) * H + row_of(lane)] = upd;
        continue;
      }
    }
    float* xr = a.xs + (size_t)(b0 + b) * H + row_of(lane);
    *xr = __fadd_rn(*xr, upd);
  }
}

// dn_pk [NP H / F, I]: a warp per two output rows (per unit at 3 and 2
// bits, as o) walks the MLP tiles in
// order, ma += (sum over the tile's groups of s_g z_g) * sa_t, then adds ma
// to the residual rows it owns (a8 staged per tile from the quantized
// activation; dn_gs [NG * gtp, H], each tile's groups padded to gtp rows).
// LORA adds xa_d . lb_d[n]^T to ma before the residual; GEMMA with
// sandwich norms writes ma to sand instead, for the norm pass.
template <int TB, int BITS, bool OPT, bool LORA, bool ARCH,
          bool GEMMA = false>
__device__ void gphase_down_rows(const W8A8Args& a, int l, int8_t* xs,
                                 float* sa_s, float* pf) {
  constexpr int F = fields<BITS>(), NP = planes<BITS>();
  constexpr int FT = F * TB, NR = F == 1 ? 2 : 1, VO = NR * FT;
  const int H = a.H, I = a.I, ti = a.ti, ng = I / ti, P = H / F;
  const int units = P / NR, nrb = (units + kWarps - 1) / kWarps;
  const int groups = (a.B + TB - 1) / TB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int8_t* pk = a.dn_pk + (size_t)l * NP * P * I;
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
            },
            (size_t)P * I);
        if (lane < VO)
          ma = __fadd_rn(ma, __fmul_rn(y, sa_s[lane % TB]));
      }
    }
    if (u >= units) continue;
    float lora = 0.f;
    const bool with_lora = lora_on<LORA, GEMMA>(a);
    if (with_lora)
      lora = lora_out<VO>(
          a.r_d,
          [&](int v) {
            return v % TB < nb ? a.xa_d + (size_t)(b0 + v % TB) * a.r_d
                               : nullptr;
          },
          [&](int v) { return a.lb_d + ((size_t)l * H + row_of(v)) * a.r_d; });
    const int b = lane % TB;
    if (lane >= VO || b >= nb) continue;
    if (with_lora) ma = __fadd_rn(ma, lora);
    if constexpr (ARCH) {
      if (a.dn_bias)
        ma = __fadd_rn(ma, a.dn_bias[(size_t)l * H + row_of(lane)]);
    }
    if constexpr (GEMMA) {
      if (a.pm_norm) {
        a.sand[(size_t)(b0 + b) * H + row_of(lane)] = ma;
        continue;
      }
    }
    float* xr = a.xs + (size_t)(b0 + b) * H + row_of(lane);
    *xr = __fadd_rn(*xr, ma);
  }
}

// ------------------------------------ kernel 14: the Walsh LUT decode
// "wl8" (BITS == kWalsh): per-row 8-entry codebooks through 3 stored bit
// planes (megapack_walsh: tile-major, plane p's byte holds bit p of the
// unit's 8 row blocks, row block r at byte bit 7 - r, unflipped). A warp
// takes two packed units (16 output rows) against a staged group of 8
// token rows and walks the product's whole column range with int8
// tensor-core products (mma.sync m16n8k32): for each XOR monomial of
// ``_MONO`` the A tile holds the 0/1 monomial bits of the 16 rows and B the
// token rows, so D accumulates the exact int32 dots z_j; an all-ones A gives
// each token's activation sum S. Integers are exact in any column order, so
// the TPU kernel's column chunks set no rounding point. Then y = c0 S + c1
// z1 + ... + c7 z7 in float32, in that order, with the row's coefficient
// rows (``walsh_y``).

// the float32 coefficient rows [L, 8, width] a Walsh pack keeps in the
// scales' slots
__device__ __forceinline__ const float* walsh_cf(const bf16* p) {
  return reinterpret_cast<const float*>(p);
}

// one int8 tensor-core product D += A B: A 16 x 32 (row-major), B 32 x 8
// (column-major), D 16 x 8 int32, in the fragment layouts of the PTX ISA
__device__ __forceinline__ void mma_s8(int (&d)[4], unsigned a0, unsigned a1,
                                       unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The integer dots of two packed units (u0, u1: their plane-0 rows, planes
// pstride bytes apart; K columns, a multiple of 64) against the 8 token rows
// staged in xs [8][K] (``padk``), over the 64-column chunks c0, c0 + cstep,
// ...: z[j] the monomial dots in ``_MONO`` order, z[7] the activation
// sums, in the D layout: lane (g = lane / 4, q = lane % 4) holds row block
// g of unit 0 at tokens 2 q and 2 q + 1 (z[.][0], z[.][1]) and of unit 1
// (z[.][2], z[.][3]). Per chunk each lane loads 16 bytes of every plane of
// both units and of its token row; the two k-32 products take the words
// 2 h and 2 h + 1 of them (a permutation of the 64 columns, the same for A
// and B).
__device__ __forceinline__ void walsh_dots(const int8_t* u0, const int8_t* u1,
                                           size_t pstride, int K,
                                           const int8_t* xs, int (&z)[8][4],
                                           int c0, int cstep) {
  constexpr unsigned m1 = 0x01010101u;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int xstride = (K >> 7) * kPad, sh = 7 - g;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) z[j][i] = 0;
  for (int k0 = 64 * c0; k0 < K; k0 += 64 * cstep) {
    const int k = k0 + 16 * q;
    const int4 xv = *reinterpret_cast<const int4*>(xs + (size_t)g * xstride +
                                                   padk(k));
    const unsigned xw[4] = {(unsigned)xv.x, (unsigned)xv.y, (unsigned)xv.z,
                            (unsigned)xv.w};
    unsigned pl[2][3][4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const int4 w = __ldg(reinterpret_cast<const int4*>(
            (u ? u1 : u0) + p * pstride + k));
        pl[u][p][0] = (unsigned)w.x;
        pl[u][p][1] = (unsigned)w.y;
        pl[u][p][2] = (unsigned)w.z;
        pl[u][p][3] = (unsigned)w.w;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned mono[2][2][7];     // [unit][word 2 h + e][monomial]
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const unsigned b0 = pl[u][0][2 * h + e], b1 = pl[u][1][2 * h + e],
                         b2 = pl[u][2][2 * h + e], b01 = b0 ^ b1;
          mono[u][e][0] = (b0 >> sh) & m1;
          mono[u][e][1] = (b1 >> sh) & m1;
          mono[u][e][2] = (b2 >> sh) & m1;
          mono[u][e][3] = (b01 >> sh) & m1;
          mono[u][e][4] = ((b0 ^ b2) >> sh) & m1;
          mono[u][e][5] = ((b1 ^ b2) >> sh) & m1;
          mono[u][e][6] = ((b01 ^ b2) >> sh) & m1;
        }
#pragma unroll
      for (int j = 0; j < 7; ++j)
        mma_s8(z[j], mono[0][0][j], mono[1][0][j], mono[0][1][j],
               mono[1][1][j], xw[2 * h], xw[2 * h + 1]);
      mma_s8(z[7], m1, m1, m1, m1, xw[2 * h], xw[2 * h + 1]);
    }
  }
}

// The Walsh dots of one unit pair split over the block's warps: warp w
// takes the chunks w, w + kWarps, ... (``walsh_dots``), and the block adds
// the warps' integers in shared memory (red: kWarps * 1024 ints), exact in
// any order; warp 0's lanes return the sums in z (the D layout). The
// columns a warp walks in turn are an eighth of the product's, so the
// chain of dependent loads is an eighth as long. Block-level: every
// thread calls it; ends with a barrier.
__device__ __forceinline__ void walsh_dots_block(const int8_t* u0,
                                                 const int8_t* u1,
                                                 size_t pstride, int K,
                                                 const int8_t* xs, int* red,
                                                 int (&z)[8][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  walsh_dots(u0, u1, pstride, K, xs, z, warp, kWarps);
  int* mine = red + warp * 1024;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) mine[(j * 4 + i) * 32 + lane] = z[j][i];
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int t = 0;
        for (int w = 0; w < kWarps; ++w) t += red[w * 1024 + (j * 4 + i) * 32 + lane];
        z[j][i] = t;
      }
  }
  __syncthreads();
}

// y = c0 S + c1 z1 + ... + c7 z7 in float32, in that order, of D value i;
// the coefficients of output row ``row`` at cf[s * width + row] (the TPU
// kernel's walsh_y recomposition, megastep_lowbit.py:471-477)
__device__ __forceinline__ float walsh_y(const float* cf, size_t width,
                                         int row, const int (&z)[8][4],
                                         int i) {
  float y = __fmul_rn(__ldg(cf + row), (float)z[7][i]);
#pragma unroll
  for (int j = 0; j < 7; ++j)
    y = __fadd_rn(y, __fmul_rn(__ldg(cf + (size_t)(j + 1) * width + row),
                               (float)z[j][i]));
  return y;
}

// The Walsh phases give a block one unit pair and one group of 8 token
// rows at a time (bu = token group * units + unit: a block stages its
// group's rows once), its warps splitting the pair's columns
// (``walsh_dots_block``); warp 0 then writes the pair's 16 rows x 8 tokens.

// qkv + rope of "wl8": a block per rope pair of packed units (gphase_qkv's
// pairs; tF = tq / 8 rows a row block); y * sx + bias (LORA: + xa_q .
// lb_q[row]; ARCH with qk_nm: to qkv_f for phase 3), rope with the partner
// (the other unit's value of the same row block and token, held by the same
// lane) in float32, bf16 out to qkv_out and kn / vn
template <bool LORA, bool ARCH, bool GEMMA>
__device__ void wphase_qkv(const W8A8Args& a, int l, int8_t* xs, int* red) {
  constexpr int TB = kGroupTB;
  const int H = a.H, Dqkv = a.q_dim + 2 * a.kv_dim, P = Dqkv / 8;
  const int tF = a.tq / 8;
  const int n_rope = a.rd ? a.q_dim + a.kv_dim : 0;
  const int units = P / 2, groups = (a.B + TB - 1) / TB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int8_t* pk = a.qkv_pk + (size_t)l * 3 * P * H;
  const float* cf = walsh_cf(a.qkv_gs) + (size_t)l * 8 * Dqkv;
  const float* bias = a.qkv_bias + (size_t)l * Dqkv;
  bf16* kn = a.kn + (size_t)l * a.B * a.kv_dim;
  bf16* vn = a.vn + (size_t)l * a.B * a.kv_dim;
  const bool with_lora = lora_on<LORA, GEMMA>(a);
  int staged = -1;
  for (int bu = blockIdx.x; bu < units * groups; bu += gridDim.x) {
    const int grp = bu / units, u = bu - grp * units;
    const int b0 = grp * TB, nb = min(TB, a.B - b0);
    if (grp != staged) {
      __syncthreads();
      stage_rows_ld<TB>(a.x8, H, 0, b0, nb, H, xs);
      staged = grp;
    }
    int p0, p1, ci;
    bool pair_rope;
    qkv_pair(u, 128, a.rd, a.interleaved, P, p0, p1, ci, pair_rope);
    int z[8][4];
    walsh_dots_block(pk + (size_t)unit_row<kWalsh>(p0, tF) * H,
                     pk + (size_t)unit_row<kWalsh>(p1, tF) * H,
                     (size_t)tF * H, H, xs, red, z);
    if (warp != 0) continue;
    int rows[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int p = e ? p1 : p0, t = p / tF;
      rows[e] = t * a.tq + g * tF + (p - t * tF);
    }
    float yv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = 2 * q + (i & 1), row = rows[i >> 1];
      yv[i] = 0.f;
      if (n >= nb) continue;
      float y = __fadd_rn(
          __fmul_rn(walsh_y(cf, Dqkv, row, z, i), a.sx[b0 + n]), bias[row]);
      if (with_lora)
        y = __fadd_rn(y, lora_b(a.xa_q + (size_t)(b0 + n) * a.r_q,
                                a.lb_q + ((size_t)l * Dqkv + row) * a.r_q,
                                a.r_q));
      yv[i] = y;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = 2 * q + (i & 1), row = rows[i >> 1], b = b0 + n;
      if (n >= nb) continue;
      if constexpr (ARCH) {
        if (a.qk_nm) {     // normed, roped and stored in phase 3
          a.qkv_f[(size_t)b * Dqkv + row] = yv[i];
          continue;
        }
      }
      float out = yv[i];
      if (pair_rope && row < n_rope) {
        const float c = rope_table<GEMMA>(a, a.cos_half, l)[(size_t)b * a.cos_ld + ci];
        const float sn = rope_table<GEMMA>(a, a.sin_half, l)[(size_t)b * a.cos_ld + ci];
        const float pv = yv[i ^ 2];
        out = __fadd_rn(__fmul_rn(yv[i], c), __fmul_rn(i < 2 ? -pv : pv, sn));
      }
      const bf16 o = __float2bfloat16(out);
      a.qkv_out[(size_t)b * Dqkv + row] = o;
      if (row >= a.q_dim + a.kv_dim)
        vn[(size_t)b * a.kv_dim + row - a.q_dim - a.kv_dim] = o;
      else if (row >= a.q_dim)
        kn[(size_t)b * a.kv_dim + row - a.q_dim] = o;
    }
  }
}

// gate/up of "wl8": a block per packed unit of gate and the same unit of
// up (tF = ti / 8; coefficient columns tile-major like gu_gs): act(g * sx)
// * (u * sx) (LORA and ARCH terms added to each first) into act_a and
// max|a| per (token row, tile) into amax
template <bool LORA, bool ARCH, bool GEMMA>
__device__ void wphase_gateup(const W8A8Args& a, int l, int8_t* xs, int* red) {
  constexpr int TB = kGroupTB;
  const int H = a.H, I = a.I, ti = a.ti, ng = I / ti;
  const int tF = ti / 8, PI = I / 8, groups = (a.B + TB - 1) / TB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int8_t* pk = a.gu_pk + (size_t)l * 2 * 3 * PI * H;
  const float* cf = walsh_cf(a.gu_gs) + (size_t)l * 8 * 2 * I;
  const bool with_lora = lora_on<LORA, GEMMA>(a);
  int staged = -1;
  for (int bu = blockIdx.x; bu < PI * groups; bu += gridDim.x) {
    const int grp = bu / PI, p = bu - grp * PI;
    const int b0 = grp * TB, nb = min(TB, a.B - b0);
    if (grp != staged) {
      __syncthreads();
      stage_rows_ld<TB>(a.x8, H, 0, b0, nb, H, xs);
      staged = grp;
    }
    const int t = p / tF, i = p - t * tF;
    const size_t ur = (size_t)unit_row<kWalsh>(p, tF);
    int z[8][4];
    walsh_dots_block(pk + ur * H, pk + ((size_t)3 * PI + ur) * H,
                     (size_t)tF * H, H, xs, red, z);
    if (warp != 0) continue;
    const int cg = (2 * t) * ti + g * tF + i, cu = cg + ti;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 2 * q + e, b = b0 + n;
      if (n >= nb) continue;
      const float sxb = a.sx[b];
      float gv = __fmul_rn(walsh_y(cf, 2 * I, cg, z, e), sxb);
      float uv = __fmul_rn(walsh_y(cf, 2 * I, cu, z, e + 2), sxb);
      if (with_lora) {
        const float* xa = a.xa_g + (size_t)b * a.r_g;
        gv = __fadd_rn(gv, lora_b(xa, a.lb_g + ((size_t)l * 2 * I + cg) * a.r_g,
                                  a.r_g));
        uv = __fadd_rn(uv, lora_b(xa, a.lb_g + ((size_t)l * 2 * I + cu) * a.r_g,
                                  a.r_g));
      }
      if constexpr (ARCH) {
        if (a.gu_bias) {
          gv = __fadd_rn(gv, a.gu_bias[(size_t)l * 2 * I + cg]);
          uv = __fadd_rn(uv, a.gu_bias[(size_t)l * 2 * I + cu]);
        }
      }
      const float v = gated(gv, uv, a.act);
      const int m = t * ti + g * tF + i;
      a.act_a[(size_t)b * I + m] = v;
      atomicMax(a.amax + (size_t)b * ng + t, __float_as_int(fabsf(v)));
    }
  }
}

// the "wl8" epilogue of o's and down's output row (token b): LORA adds
// xa . lb[row]^T, ARCH the bias; GEMMA with a sandwich norm writes the
// value to sand for the norm pass, otherwise it is added to the residual
template <bool ARCH, bool GEMMA>
__device__ __forceinline__ void walsh_out(const W8A8Args& a, int b, int row,
                                          float v, bool with_lora,
                                          const float* xa,
                                          const bf16* lb, int r,
                                          const float* bias,
                                          const float* sand_norm) {
  if (with_lora) v = __fadd_rn(v, lora_b(xa + (size_t)b * r, lb + (size_t)row * r, r));
  if constexpr (ARCH) {
    if (bias) v = __fadd_rn(v, bias[row]);
  }
  if constexpr (GEMMA) {
    if (sand_norm) {
      a.sand[(size_t)b * a.H + row] = v;
      return;
    }
  }
  float* xr = a.xs + (size_t)b * a.H + row;
  *xr = __fadd_rn(*xr, v);
}

// o of "wl8": o_pk [3 H / 8, q_dim] (one tile, P = H / 8 units); a block
// per two units (16 output rows, row g P + unit), x += y * sa (a8 staged
// from the quantized attention output)
template <bool LORA, bool ARCH, bool GEMMA>
__device__ void wphase_o(const W8A8Args& a, int l, int8_t* xs, float* sa_s,
                         int* red) {
  constexpr int TB = kGroupTB;
  const int H = a.H, K = a.q_dim, P = H / 8;
  const int units = P / 2, groups = (a.B + TB - 1) / TB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int8_t* pk = a.o_pk + (size_t)l * 3 * P * K;
  const float* cf = walsh_cf(a.o_gs) + (size_t)l * 8 * H;
  const bool with_lora = lora_on<LORA, GEMMA>(a);
  const float* bias = nullptr;
  if constexpr (ARCH) bias = a.o_bias ? a.o_bias + (size_t)l * H : nullptr;
  int staged = -1;
  for (int bu = blockIdx.x; bu < units * groups; bu += gridDim.x) {
    const int grp = bu / units, u = bu - grp * units;
    const int b0 = grp * TB, nb = min(TB, a.B - b0);
    if (grp != staged) {
      __syncthreads();
      if (threadIdx.x < TB)
        sa_s[threadIdx.x] =
            (int)threadIdx.x < nb ? attn_scale(a, b0 + threadIdx.x) : 1.f;
      stage_rows_ld<TB>(a.a8, K, 0, b0, nb, K, xs);
      staged = grp;
    }
    int z[8][4];
    walsh_dots_block(pk + (size_t)(2 * u) * K, pk + (size_t)(2 * u + 1) * K,
                     (size_t)P * K, K, xs, red, z);
    if (warp != 0) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = 2 * q + (i & 1), row = g * P + 2 * u + (i >> 1);
      if (n >= nb) continue;
      walsh_out<ARCH, GEMMA>(
          a, b0 + n, row, __fmul_rn(walsh_y(cf, H, row, z, i), sa_s[n]),
          with_lora, a.xa_o, a.lb_o + (size_t)l * H * a.r_o, a.r_o, bias,
          GEMMA ? a.pa_norm : nullptr);
    }
  }
}

// down of "wl8": dn_pk [3 H / 8, I]; a block per two units walks the MLP
// tiles in order, ma += y_t * sa_t (each tile's dots over its ti columns,
// the a8 tile staged from the quantized activation), then adds ma to the
// residual rows it owns
template <bool LORA, bool ARCH, bool GEMMA>
__device__ void wphase_down(const W8A8Args& a, int l, int8_t* xs,
                            float* sa_s, int* red) {
  constexpr int TB = kGroupTB;
  const int H = a.H, I = a.I, ti = a.ti, ng = I / ti, P = H / 8;
  const int units = P / 2, groups = (a.B + TB - 1) / TB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int8_t* pk = a.dn_pk + (size_t)l * 3 * P * I;
  const float* cf = walsh_cf(a.dn_gs) + (size_t)l * 8 * H;
  const bool with_lora = lora_on<LORA, GEMMA>(a);
  const float* bias = nullptr;
  if constexpr (ARCH) bias = a.dn_bias ? a.dn_bias + (size_t)l * H : nullptr;
  for (int bu = blockIdx.x; bu < units * groups; bu += gridDim.x) {
    const int grp = bu / units, u = bu - grp * units;
    const int b0 = grp * TB, nb = min(TB, a.B - b0);
    float ma[4] = {0.f, 0.f, 0.f, 0.f};
    for (int t = 0; t < ng; ++t) {
      __syncthreads();
      if (threadIdx.x < TB)
        sa_s[threadIdx.x] = (int)threadIdx.x < nb
                                ? tile_scale(a.amax, b0 + threadIdx.x, ng, t)
                                : 1.f;
      stage_rows_ld<TB>(a.a8, I, t * ti, b0, nb, ti, xs);
      int z[8][4];
      walsh_dots_block(pk + (size_t)(2 * u) * I + (size_t)t * ti,
                       pk + (size_t)(2 * u + 1) * I + (size_t)t * ti,
                       (size_t)P * I, ti, xs, red, z);
      if (warp == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = g * P + 2 * u + (i >> 1);
          ma[i] = __fadd_rn(ma[i], __fmul_rn(walsh_y(cf, H, row, z, i),
                                             sa_s[2 * q + (i & 1)]));
        }
      }
    }
    if (warp != 0) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = 2 * q + (i & 1), row = g * P + 2 * u + (i >> 1);
      if (n >= nb) continue;
      walsh_out<ARCH, GEMMA>(a, b0 + n, row, ma[i], with_lora, a.xa_d,
                             a.lb_d + (size_t)l * H * a.r_d, a.r_d, bias,
                             GEMMA ? a.pm_norm : nullptr);
    }
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

// ------------------------------------------------- kernel 14: the lm fold
// The trailing-unembed fold's vocab phase: a warp per two rows of the int8
// lm_head lm_w8 [V, H] (16-byte loads, the lanes across the row) against
// the final norm's int8 token rows x8 staged per token group of TB; each
// lane's int32 dp4a partial sums are added over the warp (integers: exact
// in any order), then logits[b][v] = (dv * sx[b]) * scale[v] in float32,
// as the TPU kernel's vocab tiles compute them.
template <int TB>
__device__ void gphase_vocab(const W8A8Args& a, int8_t* xs) {
  constexpr int NR = 2;
  const int H = a.H, V = a.V, n16 = H / 16, xstride = (H >> 7) * kPad;
  const int units = V / NR, nrb = (units + kWarps - 1) / kWarps;
  const int groups = (a.B + TB - 1) / TB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int staged = -1;
  for (int bu = blockIdx.x; bu < nrb * groups; bu += gridDim.x) {
    const int rb = bu / groups, grp = bu - rb * groups;
    const int b0 = grp * TB, nb = min(TB, a.B - b0);
    if (grp != staged) {
      __syncthreads();
      stage_rows_ld<TB>(a.x8, H, 0, b0, nb, H, xs);
      staged = grp;
    }
    const int u = rb * kWarps + warp;
    if (u >= units) continue;
    const int8_t* rows = a.lm_w8 + (size_t)NR * u * H;
    int acc[NR][TB];
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int b = 0; b < TB; ++b) acc[r][b] = 0;
    for (int c = lane; c < n16; c += 32) {
      int4 w[NR];
#pragma unroll
      for (int r = 0; r < NR; ++r)
        w[r] = __ldg(reinterpret_cast<const int4*>(rows + (size_t)r * H +
                                                   16 * c));
      const int kp = padk(16 * c);
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        const int4 xv =
            *reinterpret_cast<const int4*>(xs + (size_t)b * xstride + kp);
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          int t = __dp4a(w[r].x, xv.x, acc[r][b]);
          t = __dp4a(w[r].y, xv.y, t);
          t = __dp4a(w[r].z, xv.z, t);
          acc[r][b] = __dp4a(w[r].w, xv.w, t);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const int v = NR * u + r;
      const float sv = a.lm_scale[v];
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        const int dv = __reduce_add_sync(0xffffffffu, acc[r][b]);
        if (lane == r * TB + b && b < nb)
          a.logits[(size_t)(b0 + b) * V + v] =
              __fmul_rn(__fmul_rn((float)dv, a.sx[b0 + b]), sv);
      }
    }
  }
}

// ----------------------------------------------------------------- kernel
// LM: the instantiation with kernel 14's trailing-unembed fold (its own
// source, megastep_lowbit_lm.cu), so that the kernels without it keep the
// code and register allocation they have; LORA: the one with the EoRA
// epilogue (megastep_lowbit_lora*.cu), and ARCH the one with the qk-norm
// and biases (megastep_lowbit_arch*.cu), for the same reason; GEMMA the
// one with gemma's sandwich norms, windows, softcap and dual rope
// (megastep_lowbit_gemma.cu), which also carries every other optional
// operand, each run where it is set (lora_on, lm_on)
template <int TB, int BITS, bool KMAJ, bool OPT, bool LM, bool LORA,
          bool ARCH, bool GEMMA = false>
__global__ void __launch_bounds__(kThreads, 2)
    grouped_megastep_kernel(W8A8Args a) {
  static_assert(!(LORA && KMAJ), "the EoRA epilogue is kernel 14's");
  static_assert(!(ARCH && KMAJ), "qk-norm and biases are kernel 14's");
  static_assert(!(GEMMA && KMAJ), "gemma's operands are kernel 14's");
  const bool with_lora = lora_on<LORA, GEMMA>(a);
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  constexpr int kPf = pf_floats<TB, BITS>();
  float* pf = reinterpret_cast<float*>(smem + kHeadBytes) +
              (threadIdx.x >> 5) * kPf;
  unsigned char* work = smem + kHeadBytes + kWarps * kPf * sizeof(float);
  float* sa_s = reinterpret_cast<float*>(work);
  int8_t* xs_s = reinterpret_cast<int8_t*>(work + kSaBytes);
  // the Walsh walks' integer partials, one 1024-int slab a warp
  int* wred = reinterpret_cast<int*>(smem + kHeadBytes);
  const int H = a.H, I = a.I, ng = I / a.ti, Hkv = a.kv_dim / a.d;
  const size_t tid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t nthreads = (size_t)gridDim.x * kThreads;
  const size_t BH = (size_t)a.B * H;

  for (int l = 0; l < a.L; ++l) {
    // 0: layer entry (GEMMA: the previous layer's post-MLP sandwich norm
    // into the residual, a block per row, before this phase's barrier)
    for (size_t e = tid; e < BH; e += nthreads) {
      if (l == 0)
        a.xs[e] = static_cast<const float*>(a.x)[e];
      else if (KMAJ)
        kmajor_mlp_residual(a, e);
    }
    if constexpr (GEMMA) {
      if (l > 0 && a.pm_norm)
        for (int b = blockIdx.x; b < a.B; b += gridDim.x)
          sandwich_row(a, b, a.pm_norm + (size_t)(l - 1) * H, nullptr, red);
    }
    grid.sync();
    // 1: attention norm and int8 rows
    for (int b = blockIdx.x; b < a.B; b += gridDim.x)
      row_norm_quant<float>(a.xs + (size_t)b * H, H, H,
                            a.attn_norm + (size_t)l * H, a.eps, a.rms_offset,
                            a.x8 + (size_t)b * H, a.sx + b, red);
    if (with_lora)
      lora_xa(a, a.xs, H, H, a.ap_q ? a.ap_q + (size_t)l * H : nullptr,
              a.attn_norm + (size_t)l * H, a.la_q + (size_t)l * a.r_q * H,
              a.r_q, a.xa_q, reinterpret_cast<float*>(xs_s));
    grid.sync();
    // 2: qkv + rope; zero the MLP tile maxima
    for (size_t e = tid; e < (size_t)a.B * ng; e += nthreads) a.amax[e] = 0;
    if constexpr (BITS == kWalsh)
      wphase_qkv<LORA, ARCH, GEMMA>(a, l, xs_s, wred);
    else
      gphase_qkv<TB, BITS, KMAJ, OPT, LORA, ARCH, GEMMA>(a, l, xs_s, pf);
    grid.sync();
    // 3: attention (with qk-norm, its heads normed and roped first; GEMMA:
    // the layer's window and the softcap)
    for (int u = blockIdx.x; u < a.B * Hkv; u += gridDim.x) {
      const int b = u / Hkv, g = u - b * Hkv;
      if constexpr (ARCH) {
        if (a.qk_nm)
          qk_norm_rope_heads<GEMMA>(a, l, b, g,
                                    reinterpret_cast<float*>(work));
      }
      const size_t off = (size_t)l * a.cache_sl + (size_t)b * a.cache_sb +
                         (size_t)g * a.cache_sg;
      const int pos = a.pos[b];
      int t_lo = 0;
      if constexpr (GEMMA) {
        if (a.windows) t_lo = max(0, pos - a.windows[l] + 1);
      }
      attn_unit<GEMMA>(a, b, g, a.qkv_out, a.k_cache + off, a.v_cache + off,
                       a.attn, a.attn_amax, reinterpret_cast<float*>(work),
                       pos, t_lo, a.softcap);
    }
    grid.sync();
    // 4: the attention output's int8 rows
    for (size_t e = tid; e < (size_t)a.B * a.q_dim; e += nthreads)
      a.a8[e] = (int8_t)quant8(a.attn[e], attn_scale(a, (int)(e / a.q_dim)));
    if (with_lora)
      lora_xa(a, a.attn, a.q_dim, a.q_dim,
              a.ap_o ? a.ap_o + (size_t)l * a.q_dim : nullptr, nullptr,
              a.la_o + (size_t)l * a.r_o * a.q_dim, a.r_o, a.xa_o,
              reinterpret_cast<float*>(xs_s));
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
    } else if constexpr (BITS == kWalsh) {
      wphase_o<LORA, ARCH, GEMMA>(a, l, xs_s, sa_s, wred);
    } else {
      gphase_o_rows<TB, BITS, OPT, LORA, ARCH, GEMMA>(a, l, xs_s, sa_s, pf);
    }
    grid.sync();
    // 6: (GEMMA) the post-attention sandwich norm into the residual, then
    // the MLP norm and int8 rows: the block of row b does both, except with
    // the EoRA epilogue, whose A product reads every row (a barrier between)
    bool sand_a = false;
    if constexpr (GEMMA) {
      sand_a = a.pa_norm != nullptr;
      if (sand_a && with_lora) {
        for (int b = blockIdx.x; b < a.B; b += gridDim.x)
          sandwich_row(a, b, a.pa_norm + (size_t)l * H, nullptr, red);
        grid.sync();
        sand_a = false;
      }
    }
    for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
      if (sand_a) sandwich_row(a, b, a.pa_norm + (size_t)l * H, nullptr, red);
      row_norm_quant<float>(a.xs + (size_t)b * H, H, H,
                            a.mlp_norm + (size_t)l * H, a.eps, a.rms_offset,
                            a.x8 + (size_t)b * H, a.sx + b, red);
    }
    if (with_lora)
      lora_xa(a, a.xs, H, H, a.ap_g ? a.ap_g + (size_t)l * H : nullptr,
              a.mlp_norm + (size_t)l * H, a.la_g + (size_t)l * a.r_g * H,
              a.r_g, a.xa_g, reinterpret_cast<float*>(xs_s));
    grid.sync();
    // 7: gate/up
    if constexpr (BITS == kWalsh)
      wphase_gateup<LORA, ARCH, GEMMA>(a, l, xs_s, wred);
    else
      gphase_gateup<TB, BITS, KMAJ, OPT, LORA, ARCH, GEMMA>(a, l, xs_s, pf);
    grid.sync();
    // 8: the activation's int8 rows per tile
    for (size_t e = tid; e < (size_t)a.B * I; e += nthreads) {
      const int b = (int)(e / I), m = (int)(e % I);
      a.a8[e] = (int8_t)quant8(a.act_a[e], tile_scale(a.amax, b, ng, m / a.ti));
    }
    if (with_lora)
      lora_xa(a, a.act_a, I, a.ti, nullptr, nullptr,
              a.la_d + (size_t)l * a.r_d * I, a.r_d, a.xa_d,
              reinterpret_cast<float*>(xs_s));
    grid.sync();
    // 9: down
    if constexpr (KMAJ) {
      const bf16* ds = a.dn_gs + (size_t)l * ng * a.gtp * H;
      const int gti = a.ti / a.gs;
      gphase_kmajor<TB>(a, a.dn_pk + (size_t)l * I * (H / 2), I, H, I,
                        reinterpret_cast<int*>(work), [&](int g) {
                          return ds + (size_t)((g / gti) * a.gtp + g % gti) * H;
                        });
    } else if constexpr (BITS == kWalsh) {
      wphase_down<LORA, ARCH, GEMMA>(a, l, xs_s, sa_s, wred);
    } else {
      gphase_down_rows<TB, BITS, OPT, LORA, ARCH, GEMMA>(a, l, xs_s, sa_s,
                                                         pf);
    }
    grid.sync();
  }
  bool sand_m = false;
  if constexpr (GEMMA) sand_m = a.pm_norm != nullptr;
  if (sand_m) {     // the last layer's post-MLP sandwich norm, y = x
    for (int b = blockIdx.x; b < a.B; b += gridDim.x)
      sandwich_row(a, b, a.pm_norm + (size_t)(a.L - 1) * H,
                   static_cast<float*>(a.y), red);
  } else {
    for (size_t e = tid; e < BH; e += nthreads) {
      if (KMAJ) kmajor_mlp_residual(a, e);
      static_cast<float*>(a.y)[e] = a.xs[e];
    }
  }
  if (lm_on<LM, GEMMA>(a)) {
    // kernel 14's trailing-unembed fold: the final norm and int8 rows of
    // the residual, then the vocab phase, after a barrier each
    grid.sync();
    for (int b = blockIdx.x; b < a.B; b += gridDim.x)
      row_norm_quant<float>(a.xs + (size_t)b * H, H, H, a.lm_norm, a.eps,
                            a.rms_offset, a.x8 + (size_t)b * H, a.sx + b,
                            red);
    grid.sync();
    gphase_vocab<TB>(a, xs_s);
  }
}

// whether any of kernel 14's gemma operands is set (only the GEMMA
// instantiation takes them)
__host__ __forceinline__ bool gemma_any(const W8A8Args* p) {
  return p->pa_norm || p->pm_norm || p->windows || p->rope_sel || p->sand ||
         p->softcap != 0.f;
}

template <int TB, int BITS, bool KMAJ, bool OPT, bool LM, bool LORA,
          bool ARCH, bool GEMMA = false>
cudaError_t launch_grouped(const W8A8Args& a, cudaStream_t s) {
  if (!GEMMA && gemma_any(&a)) return cudaErrorInvalidValue;
  auto kernel =
      grouped_megastep_kernel<TB, BITS, KMAJ, OPT, LM, LORA, ARCH, GEMMA>;
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

// OPT: the kernel that reads kernel 14's zero points and act-order orders;
// LM: the one with its trailing-unembed fold; LORA: the one with its EoRA
// epilogue; ARCH: the one with its qk-norm and biases; GEMMA: the one with
// gemma's operands (and all the others, each where it is set)
template <int BITS, bool KMAJ, bool OPT, bool LM = false, bool LORA = false,
          bool ARCH = false, bool GEMMA = false>
cudaError_t launch_grouped_b(const W8A8Args& a, cudaStream_t s) {
  // the Walsh walks stage 8 token rows for the tensor-core products; the
  // other decodes stage as few as the batch needs, at most max_tb<BITS>()
  if constexpr (BITS == kWalsh) {
    return launch_grouped<kGroupTB, BITS, KMAJ, OPT, LM, LORA, ARCH, GEMMA>(
        a, s);
  } else {
    if (a.B <= 1)
      return launch_grouped<1, BITS, KMAJ, OPT, LM, LORA, ARCH, GEMMA>(a, s);
    if constexpr (max_tb<BITS>() == 2) {
      return launch_grouped<2, BITS, KMAJ, OPT, LM, LORA, ARCH, GEMMA>(a, s);
    } else {
      if (a.B <= 2)
        return launch_grouped<2, BITS, KMAJ, OPT, LM, LORA, ARCH, GEMMA>(a, s);
      if constexpr (max_tb<BITS>() == 4) {
        return launch_grouped<4, BITS, KMAJ, OPT, LM, LORA, ARCH, GEMMA>(a, s);
      } else {
        if (a.B <= 4)
          return launch_grouped<4, BITS, KMAJ, OPT, LM, LORA, ARCH, GEMMA>(a,
                                                                           s);
        return launch_grouped<kGroupTB, BITS, KMAJ, OPT, LM, LORA, ARCH,
                              GEMMA>(a, s);
      }
    }
  }
}

// whether any EoRA operand is set, and whether all of them are (a
// LORA launch needs every one and positive ranks; the others none)
__host__ __forceinline__ bool lora_any(const W8A8Args* p) {
  return p->la_q || p->lb_q || p->la_o || p->lb_o || p->la_g || p->lb_g ||
         p->la_d || p->lb_d || p->xa_q || p->xa_o || p->xa_g || p->xa_d;
}

__host__ __forceinline__ bool lora_all(const W8A8Args* p) {
  return p->la_q && p->lb_q && p->la_o && p->lb_o && p->la_g && p->lb_g &&
         p->la_d && p->lb_d && p->xa_q && p->xa_o && p->xa_g && p->xa_d &&
         p->r_q > 0 && p->r_o > 0 && p->r_g > 0 && p->r_d > 0 &&
         !p->kmajor && p->B <= 64 && p->H % 8 == 0 && p->q_dim % 8 == 0 &&
         p->ti % 8 == 0;
}

// whether any of kernel 14's qk-norm and bias operands is set, and whether
// they make an ARCH launch: the qk-norm rows with their scratch, or the
// three biases, or both, on row-major packs at batch <= 64
__host__ __forceinline__ bool arch_any(const W8A8Args* p) {
  return p->qk_nm || p->o_bias || p->gu_bias || p->dn_bias || p->qkv_f;
}

__host__ __forceinline__ bool arch_ok(const W8A8Args* p) {
  const bool biases = p->o_bias && p->gu_bias && p->dn_bias;
  const bool none = !p->o_bias && !p->gu_bias && !p->dn_bias;
  return !p->kmajor && p->B <= 64 && (biases || none) &&
         (p->qk_nm != nullptr) == (p->qkv_f != nullptr) &&
         (p->qk_nm || biases);
}

// whether they make a GEMMA launch: row-major packs at batch <= 64, both
// sandwich norms with their scratch or none, and the ARCH operands
// (nullable there) each whole
__host__ __forceinline__ bool gemma_ok(const W8A8Args* p) {
  const bool sand = p->pa_norm && p->pm_norm && p->sand;
  const bool no_sand = !p->pa_norm && !p->pm_norm && !p->sand;
  const bool biases = p->o_bias && p->gu_bias && p->dn_bias;
  const bool no_biases = !p->o_bias && !p->gu_bias && !p->dn_bias;
  return !p->kmajor && p->B <= 64 && (sand || no_sand) &&
         (biases || no_biases) &&
         (p->qk_nm != nullptr) == (p->qkv_f != nullptr) &&
         (p->rope_sel == nullptr || p->rd > 0);
}

// a kernel-14 call with the fold: row-major packs, batch <= 64, every lm
// operand and an even vocabulary (the vocab phase's warps take row pairs)
__host__ __forceinline__ bool lm_operands_ok(const W8A8Args* p) {
  return !p->kmajor && p->B <= 64 && p->lm_w8 && p->lm_scale && p->lm_norm &&
         p->logits && p->V > 0 && p->V % 2 == 0;
}

}  // namespace
