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
// barrier). Per layer, with a grid barrier after each (7 a layer at one
// token row, 8 with more):
//
//   1  the layer's entry into the residual row (the input at layer 0),
//      then the attention norm and int8 rows: a block per token row
//      (kernel 13 adds the previous layer's MLP from its group partials
//      over the grid, and the last unit of a row to finish forms its norm
//      through a counter per row)
//   2  qkv + bias + rope, a warp per rope pair of packed rows; zero the
//      MLP tile maxima
//   3  flash attention, an item per (flash block, token row, kv head),
//      each row at its own history length pos[b] (gphase_attention: the
//      blocks' maxima published and their p . v combined in block order by
//      the unit's last item)
//   4  the o product, whose staging forms the attention output's int8 rows
//      (quant8 with the row's scale over all heads, attn_scale: the codes
//      an int8 pass would store): kernel 14 a warp per two output rows,
//      which adds (sum_g s_g z_g) * sa to the residual rows it owns;
//      kernel 13 (K-major o) a block per (group, 1024 byte columns)
//      writing s_g * z_g, summed in group order by phase 5
//   5  (kernel 13: the o residual over the grid) the MLP norm and int8
//      rows, a block per row
//   6  gate/up, a warp per (gate, up) packed row pair: act(g) * u and the
//      per-tile max|a| (integer max on float bits); with more than one
//      token row the activation's int8 rows per tile follow in a pass of
//      their own (at one, down forms them as it stages them)
//   7  the down product: kernel 14 a warp per two output rows walking the
//      ti tiles in order (ma += y_t * sa_t, then x += ma); kernel 13 group
//      partials as in 4, summed at the next layer's entry
//
// At 8 bits the products of one or two token rows take every lane
// (group_dot_wide), and at 4 and 8 bits batches of token groups (B > 8)
// take the tensor-core tiles of the TCK instantiation (warp_tile_dot).
//
// Kernel 14 with the EoRA epilogue (the LORA instantiations) adds the rank-r
// terms of the TPU kernel: phase 1 forms xa_q = xf . la_q^T from the
// normed float rows (xf before their int8 rows), which phase 2 adds as
// xa_q . lb_q[row]^T after the qkv bias and before rope; a pass after
// phase 3, with a barrier of its own, forms xa_o from the float attention
// output, which phase 4 adds with the o product before the residual; phase
// 5 forms xa_g, which phase 6 adds to gate and up before the activation;
// the pass after phase 6 (with a barrier of its own) forms xa_d = sum over the
// MLP tiles, in tile order, of a_t . la_d[:, t]^T from the float
// activation, which phase 7 adds with the down product. The A
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
// bf16: every item of the unit writes the same values, and the norm adds
// no grid barrier.
//
// Kernel 14 with gemma's operands (the GEMMA instantiation,
// megastep_lowbit_gemma.cu, which also takes every operand above, each run
// where it is set) adds the TPU kernel's with_sand, with_win, softcap and
// rope_sel: o's and down's products (bias and EoRA term added) go to the
// scratch sand instead of the residual, and a row pass (sandwich_row, a
// block per token row) norms them into it: the post-attention norm with
// the MLP norm of phase 5, the post-MLP norm with the next layer's
// attention norm of phase 1 (one more grid barrier each only with the
// EoRA epilogue, whose A products read every row) or, after the last
// layer, with y; phase 3 reads a sliding layer's keys from pos - window + 1
// (none before it read; its first block runs to the next multiple of Tb,
// so the blocks are a walk's from key 0) and caps the scaled scores;
// rope_table picks layer l's table of two.
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
// and r = 64), over 3.35 TB/s. The row phases (1, 5) still keep a block a
// token row busy and the rest at the barrier.

#pragma once

#include <cooperative_groups.h>

#include <algorithm>

#include "mma_sync.cuh"
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

// group_dot at 4 and 8 bits, one or two token rows and 128-column groups,
// with every lane loading: lane l takes the 16-byte chunks l, l + 32, ...
// of each packed row (a group is 8 consecutive chunks: at load step i
// lanes 8 j .. 8 j + 7 hold group 4 i + j), a window's 8 / NR load steps
// in flight at once, lane j holding the scales of the window's group j.
// Each lane forms the dp4a partial dots of its chunk; the group's 8 lanes
// add them (integers: exact, in any order) and its first lane writes p =
// s_g z (+ sz_g S_g with ZP) into the warp's partials pf; then lane v < V
// sums the window's groups in order, as group_dot does: the same floats.
template <int TB, int BITS, int NR, bool ZP, typename Scale, typename Sz>
__device__ __forceinline__ float group_dot_wide(
    const int8_t* const (&rows)[NR], int K, const int8_t* xs, bool hi_first,
    float* pf, Scale scale, Sz sz) {
  constexpr int F = fields<BITS>();
  constexpr int V = NR * F * TB, RF = NR * F;
  constexpr int kWin = 8 / NR;              // load steps of a window
  static_assert(BITS == 4 || BITS == 8, "one or two codes a byte");
  const int lane = threadIdx.x & 31;
  const int G = K >> 7, NL = K >> 4, xstride = (K >> 7) * kPad;
  float y = 0.f;
  for (int g0 = 0; g0 < G; g0 += 4 * kWin) {
    const int c0 = g0 * 8;                  // the window's first chunk
    const int n = min(4 * kWin, G - g0);    // the window's groups
    int4 w[kWin][NR];
#pragma unroll
    for (int i = 0; i < kWin; ++i) {
      const int c = c0 + 32 * i + lane;
      const bool ok = c < NL;
#pragma unroll
      for (int r = 0; r < NR; ++r)
        w[i][r] = ok ? __ldg(reinterpret_cast<const int4*>(rows[r] + 16 * c))
                     : make_int4(0, 0, 0, 0);
    }
    // lane j holds the scales of the window's group j, for its writer
    float sgl[RF], zgl[RF];
#pragma unroll
    for (int u = 0; u < RF; ++u) {
      sgl[u] = lane < n ? scale(u * TB, g0 + lane) : 0.f;
      if constexpr (ZP) zgl[u] = lane < n ? sz(u * TB, g0 + lane) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kWin; ++i) {
      if (4 * i >= n) break;                // uniform across the warp
      const int c = c0 + 32 * i + lane;
      const bool ok = c < NL;
      int xw[TB][4];
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        int4 xv = make_int4(0, 0, 0, 0);
        if (ok)
          xv = *reinterpret_cast<const int4*>(xs + (size_t)b * xstride +
                                             padk(16 * c));
        xw[b][0] = xv.x; xw[b][1] = xv.y; xw[b][2] = xv.z; xw[b][3] = xv.w;
      }
      int acc[V], xsum[TB];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0;
#pragma unroll
      for (int b = 0; b < TB; ++b) {
        xsum[b] = 0;
        if constexpr (ZP) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            xsum[b] = __dp4a(xw[b][j], 0x01010101, xsum[b]);
        }
      }
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const int ww[4] = {w[i][r].x, w[i][r].y, w[i][r].z, w[i][r].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (BITS == 8) {
#pragma unroll
            for (int b = 0; b < TB; ++b)
              acc[r * TB + b] = __dp4a(ww[j], xw[b][j], acc[r * TB + b]);
          } else {
            int hi, lo;
            nibbles((unsigned)ww[j], hi, lo);
            const int f0 = hi_first ? hi : lo, f1 = hi_first ? lo : hi;
#pragma unroll
            for (int b = 0; b < TB; ++b) {
              acc[2 * r * TB + b] = __dp4a(f0, xw[b][j], acc[2 * r * TB + b]);
              acc[(2 * r + 1) * TB + b] =
                  __dp4a(f1, xw[b][j], acc[(2 * r + 1) * TB + b]);
            }
          }
        }
      }
      // the group's 8 lanes' integers
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], o);
        if constexpr (ZP) {
#pragma unroll
          for (int b = 0; b < TB; ++b)
            xsum[b] += __shfl_xor_sync(0xffffffffu, xsum[b], o);
        }
      }
      const int gl = 4 * i + (lane >> 3);   // the group in the window
      float sg[RF], zg[RF];
#pragma unroll
      for (int u = 0; u < RF; ++u) {
        sg[u] = __shfl_sync(0xffffffffu, sgl[u], gl);
        if constexpr (ZP) zg[u] = __shfl_sync(0xffffffffu, zgl[u], gl);
      }
      if ((lane & 7) == 0 && ok) {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float p = __fmul_rn(sg[v / TB], (float)acc[v]);
          if constexpr (ZP)
            p = __fadd_rn(p, __fmul_rn(zg[v / TB], (float)xsum[v % TB]));
          pf[gl * (V + 1) + v] = p;
        }
      }
    }
    __syncwarp();
    if (lane < V)
      for (int j = 0; j < n; ++j) y = __fadd_rn(y, pf[j * (V + 1) + lane]);
    __syncwarp();
  }
  return y;
}

// group_dot with the zero-point corrections where szs is given; OPT (a
// kernel with optional operands) compiles that choice in at all, so that
// the symmetric kernels carry none of it. At 4 and 8 bits, one or two
// token rows and 128-column groups at 8 bits: group_dot_wide (at 4 bits
// its group sums and nibble fields cost more than its loads gain, PERF.md)
template <int TB, int BITS, int NR, bool OPT, typename Scale, typename Sz>
__device__ __forceinline__ float group_dot_zp(
    const int8_t* const (&rows)[NR], int K, const int8_t* xs, int gs,
    bool hi_first, float* pf, Scale scale, const float* szs, Sz sz,
    size_t pstride = 0) {
  if constexpr (BITS == 8 && TB <= 2) {
    if (gs == 128) {
      if constexpr (OPT) {
        if (szs)
          return group_dot_wide<TB, BITS, NR, true>(rows, K, xs, hi_first,
                                                    pf, scale, sz);
      }
      return group_dot_wide<TB, BITS, NR, false>(rows, K, xs, hi_first, pf,
                                                 scale, sz);
    }
  }
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

// token rows b0 .. b0 + nb of the float32 activations src (row stride ld;
// columns k0 .. k0 + K, or with OPT and perm given column perm[k] for
// staged column k) as int8 codes quant8(v, sa[b]) into xs [TB][K] padded
// (``padk``); rows past nb are zeros: the codes an int8 pass would store
// (the attention output's with its row scale, an MLP tile's with its tile
// scale), formed where a product stages them. Block-level: sa must be
// visible to every thread; ends with a barrier.
template <int TB, bool OPT>
__device__ void stage_quant(const float* __restrict__ src, int ld,
                            const int* __restrict__ perm, int k0, int b0,
                            int nb, int K, const float* sa, int8_t* xs) {
  const int xstride = (K >> 7) * kPad;
  if (OPT && perm) {
    for (int e = threadIdx.x; e < TB * K; e += kThreads) {
      const int b = e / K, k = e - b * K;
      xs[(size_t)b * xstride + padk(k)] =
          b < nb ? (int8_t)quant8(src[(size_t)(b0 + b) * ld + __ldg(perm + k)],
                                  sa[b])
                 : (int8_t)0;
    }
  } else {
    const int n4 = K / 4;
    for (int e = threadIdx.x; e < TB * n4; e += kThreads) {
      const int b = e / n4, c = e - b * n4;
      unsigned v = 0;
      if (b < nb) {
        const float4 f = *reinterpret_cast<const float4*>(
            src + (size_t)(b0 + b) * ld + k0 + 4 * c);
        const float s = sa[b];
        v = (unsigned)(quant8(f.x, s) & 0xff) |
            ((unsigned)(quant8(f.y, s) & 0xff) << 8) |
            ((unsigned)(quant8(f.z, s) & 0xff) << 16) |
            ((unsigned)(quant8(f.w, s) & 0xff) << 24);
      }
      *reinterpret_cast<unsigned*>(xs + (size_t)b * xstride + padk(4 * c)) = v;
    }
  }
  __syncthreads();
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

// ------------------------------------------ 4 and 8 bits: tensor-core tiles
// At 4 and 8 bits the row-major products take their group dots on int8
// mma.sync m16n8k32: a warp takes a tile of 16 output rows (8 pair-nibble
// packed rows at 4 bits, both fields; 16 packed rows at 8) against a
// staged token group of up to 8 rows (the N side; a batch's token groups
// are the inner unit index, as before) and walks the product's groups in
// order. Each lane loads 16 bytes of its two packed rows (8 bits: of four)
// per 128 columns, every lane busy, with kTileRing chunks and their
// scales in flight in registers; the codes enter the products as they are
// stored (8 bits: the byte XOR 128 is the centred code) or as the two
// nibble fields' centred codes (``nibbles``). Inside a 128-column chunk the
// k order is a permutation of the columns, the same for the codes and the
// activations (lane t's words 2 s, 2 s + 1 of its two 16-byte pieces at k
// step s), and the sums are integers: the group dots z are exact, the
// dp4a walk's. Each lane then adds p_g = s_g z_g (+ sz_g S_g with zero
// points, S_g the group's activation sums from a product with all-ones
// codes) to the sums of the (row, token) pairs it holds, group after group
// in order: the TPU kernel's floats, with no barrier. A weight byte is
// read once per token group (from L2 after the first) and multiplied on
// the tensor cores, where the dp4a walk multiplied it once per token.
template <int BITS>
__host__ __device__ constexpr int tile_ring() {
  return BITS == 4 ? 4 : 2;       // chunks in flight (4 KB of codes a warp)
}


// tiles a block's iteration gives its warps (one each): the fewest, a
// power of two up to kWarps, whose iterations fill the grid once
__device__ __forceinline__ int tiles_per_block(int work) {
  int w = 1;
  while (w < kWarps && (long long)w * gridDim.x < work) w *= 2;
  return w;
}

// The warp's tile: tile row m < 16 is field f(m) of packed row i(m) (4
// bits: m < 8 the first field, ``hi_first``: the high nibble, of packed
// row m, m >= 8 the second field of packed row m - 8; 8 bits: packed row
// m), lane (g, t) reading packed rows r0 = row g and r1 = row g + 8 (8
// bits; at 4 bits r0 serves both) with scale columns c0 (tile row g) and
// c1 (g + 8); xs [TB][K] the staged token rows (``padk``), rows past TB
// zero. Returns in y the sums of tile rows g and g + 8 at token rows 2 t
// and 2 t + 1 (y[0], y[1] and y[2], y[3]).
template <int TB, int BITS, bool ZP, typename Scale, typename Sz>
__device__ __forceinline__ void warp_tile_dot(const int8_t* r0,
                                              const int8_t* r1, int c0,
                                              int c1, int K,
                                              const int8_t* xs, int gs,
                                              bool hi_first, Scale scale,
                                              Sz sz, float (&y)[4]) {
  static_assert(BITS == 4 || BITS == 8, "the tile path's codes");
  constexpr int R = tile_ring<BITS>();
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  const int nc = K >> 7, nch = gs >> 7;
  const bool tok = g8 < TB;
  const int8_t* xr = xs + (size_t)(tok ? g8 : 0) * ((K >> 7) * kPad) + 16 * t4;
  int4 w[R][2], v[R][2];
  float s[R][2], u[R][2];
  // chunk q's codes, and at a group's last chunk the group's scales
  auto load = [&](int q, int4 (&wq)[2], int4 (&vq)[2], float (&sq)[2],
                  float (&uq)[2]) {
    const int k = q * 128 + 16 * t4;
    wq[0] = __ldg(reinterpret_cast<const int4*>(r0 + k));
    wq[1] = __ldg(reinterpret_cast<const int4*>(r0 + k + 64));
    if constexpr (BITS == 8) {
      vq[0] = __ldg(reinterpret_cast<const int4*>(r1 + k));
      vq[1] = __ldg(reinterpret_cast<const int4*>(r1 + k + 64));
    }
    if (q % nch == nch - 1) {
      const int g = q / nch;
      sq[0] = scale(c0, g);
      sq[1] = scale(c1, g);
      if constexpr (ZP) {
        uq[0] = sz(c0, g);
        uq[1] = sz(c1, g);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (i < nc) load(i, w[i], v[i], s[i], u[i]);
#pragma unroll
  for (int e = 0; e < 4; ++e) y[e] = 0.f;
  int z[4] = {0, 0, 0, 0}, zs[4] = {0, 0, 0, 0};
  for (int q0 = 0; q0 < nc; q0 += R) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int q = q0 + i;
      if (q >= nc) break;
      int4 x0 = make_int4(0, 0, 0, 0), x1 = x0;
      if (tok) {
        x0 = *reinterpret_cast<const int4*>(xr + q * kPad);
        x1 = *reinterpret_cast<const int4*>(xr + q * kPad + 64);
      }
      const unsigned xw[8] = {(unsigned)x0.x, (unsigned)x0.y, (unsigned)x0.z,
                              (unsigned)x0.w, (unsigned)x1.x, (unsigned)x1.y,
                              (unsigned)x1.z, (unsigned)x1.w};
      const unsigned aw[8] = {
          (unsigned)w[i][0].x, (unsigned)w[i][0].y, (unsigned)w[i][0].z,
          (unsigned)w[i][0].w, (unsigned)w[i][1].x, (unsigned)w[i][1].y,
          (unsigned)w[i][1].z, (unsigned)w[i][1].w};
      unsigned bw[8];
      if constexpr (BITS == 8) {
        bw[0] = (unsigned)v[i][0].x; bw[1] = (unsigned)v[i][0].y;
        bw[2] = (unsigned)v[i][0].z; bw[3] = (unsigned)v[i][0].w;
        bw[4] = (unsigned)v[i][1].x; bw[5] = (unsigned)v[i][1].y;
        bw[6] = (unsigned)v[i][1].z; bw[7] = (unsigned)v[i][1].w;
      }
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        uint32_t fa[4];
        if constexpr (BITS == 4) {
          int h0, l0, h1, l1;
          nibbles(aw[2 * st], h0, l0);
          nibbles(aw[2 * st + 1], h1, l1);
          fa[0] = (uint32_t)(hi_first ? h0 : l0);
          fa[1] = (uint32_t)(hi_first ? l0 : h0);
          fa[2] = (uint32_t)(hi_first ? h1 : l1);
          fa[3] = (uint32_t)(hi_first ? l1 : h1);
        } else {
          fa[0] = aw[2 * st];
          fa[1] = bw[2 * st];
          fa[2] = aw[2 * st + 1];
          fa[3] = bw[2 * st + 1];
        }
        mma_s8(z, fa, xw[2 * st], xw[2 * st + 1]);
        if constexpr (ZP) {
          constexpr uint32_t kOnes[4] = {0x01010101u, 0x01010101u,
                                         0x01010101u, 0x01010101u};
          mma_s8(zs, kOnes, xw[2 * st], xw[2 * st + 1]);
        }
      }
      if (q % nch == nch - 1) {           // the group's last chunk
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = __fmul_rn(s[i][e >> 1], (float)z[e]);
          if constexpr (ZP) {
            p = __fadd_rn(p, __fmul_rn(u[i][e >> 1], (float)zs[e]));
            zs[e] = 0;
          }
          y[e] = __fadd_rn(y[e], p);
          z[e] = 0;
        }
      }
      if (q + R < nc) load(q + R, w[i], v[i], s[i], u[i]);
    }
  }
}

// warp_tile_dot with the zero-point corrections where szs is given (OPT:
// as group_dot_zp)
template <int TB, int BITS, bool OPT, typename Scale, typename Sz>
__device__ __forceinline__ void warp_tile_dot_zp(
    const int8_t* r0, const int8_t* r1, int c0, int c1, int K,
    const int8_t* xs, int gs, bool hi_first, Scale scale, const float* szs,
    Sz sz, float (&y)[4]) {
  if constexpr (OPT) {
    if (szs) {
      warp_tile_dot<TB, BITS, true>(r0, r1, c0, c1, K, xs, gs, hi_first,
                                    scale, sz, y);
      return;
    }
  }
  warp_tile_dot<TB, BITS, false>(r0, r1, c0, c1, K, xs, gs, hi_first, scale,
                                 sz, y);
}

// a lane's warp_tile_dot sums into the warp's tile [16][8] of shared
// memory (after the warp's reads of the last tile), for the units' lanes
__device__ __forceinline__ void tile_store(float* yt, const float (&y)[4]) {
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  __syncwarp();
  *reinterpret_cast<float2*>(yt + g8 * 8 + 2 * t4) = make_float2(y[0], y[1]);
  *reinterpret_cast<float2*>(yt + (g8 + 8) * 8 + 2 * t4) =
      make_float2(y[2], y[3]);
  __syncwarp();
}

// the tile row of value v of a unit whose packed rows are tile rows i0 (r
// = 0) and i0 + di (r = 1), value v = (r F + f) TB + b: field f of packed
// row i0 + r di (F = 2: tile rows i and i + 8; F = 1: row i)
template <int TB, int F>
__device__ __forceinline__ int tile_row(int v, int i0, int di) {
  const int r = v / (F * TB), f = (v / TB) % F, i = i0 + r * di;
  return F == 2 ? i + 8 * f : i;
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
          bool GEMMA = false, bool TCK = false>
__device__ void gphase_qkv(const W8A8Args& a, int l, int8_t* xs, float* pf) {
  constexpr int F = fields<BITS>(), NP = planes<BITS>();
  constexpr int FT = F * TB;
  // TC (the TCK kernel: 4 and 8 bits, batches of token groups): a warp's
  // tile holds U
  // rope pairs (warp_tile_dot); otherwise a warp takes one (group_dot)
  constexpr bool TC = TCK && (BITS == 4 || BITS == 8);
  constexpr int U = TC ? 8 / F : 1;
  const int H = a.H, Dqkv = a.q_dim + 2 * a.kv_dim, P = Dqkv / F;
  const int G = H / a.gs, tF = a.tq / F;
  const int n_rope = a.rd ? a.q_dim + a.kv_dim : 0;
  const int units = P / 2, groups = (a.B + TB - 1) / TB;
  const int ntiles = units / U;
  const int W = TC ? tiles_per_block(ntiles * groups) : kWarps;
  const int nrb = (ntiles + W - 1) / W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int8_t* pk = a.qkv_pk + (size_t)l * NP * P * H;
  const bf16* sc = a.qkv_gs + (size_t)l * G * Dqkv;
  const float* bias = a.qkv_bias + (size_t)l * Dqkv;
  const float* szs = a.qkv_sz ? a.qkv_sz + (size_t)l * G * Dqkv : nullptr;
  const int* perm = a.ap_q ? a.ap_q + (size_t)l * H : nullptr;
  bf16* kn = a.kn + (size_t)l * a.B * a.kv_dim;
  bf16* vn = a.vn + (size_t)l * a.B * a.kv_dim;
  float* yt = pf;                       // TC: the warp's tile sums
  // output row of field f of packed row p
  auto out_row = [&](int p, int f) {
    const int t = p / tF;
    return t * a.tq + f * tF + (p - t * tF);
  };
  int staged = -1;
  for (int bu = blockIdx.x; bu < nrb * groups; bu += gridDim.x) {
    const int rb = bu / groups, grp = bu - rb * groups;
    const int b0 = grp * TB, nb = min(TB, a.B - b0);
    if (grp != staged) {
      __syncthreads();
      stage_rows_ord<TB, OPT>(a.x8, perm, b0, nb, H, xs);
      staged = grp;
    }
    const int tile = rb * W + warp;      // TC: the warp's tile; else unit
    if (warp >= W || tile >= ntiles) continue;
    if constexpr (TC) {
      // tile row i < U: the first packed row of pair tile U + i; U + i:
      // its second
      auto packed = [&](int i) {
        int q0, q1, c;
        bool rp;
        qkv_pair(tile * U + i % U, 128, a.rd, a.interleaved, P, q0, q1, c,
                 rp);
        return i < U ? q0 : q1;
      };
      auto orow = [&](int m) {
        return F == 2 ? out_row(packed(m & 7), m >> 3) : out_row(packed(m), 0);
      };
      const int g8 = lane >> 2;
      float y4[4];
      warp_tile_dot_zp<TB, BITS, OPT>(
          pk + (size_t)packed(g8) * H,
          pk + (size_t)packed(F == 2 ? g8 : g8 + 8) * H, orow(g8),
          orow(g8 + 8), H, xs, a.gs, !KMAJ,
          [&](int c, int g) { return bf(sc, (size_t)g * Dqkv + c); }, szs,
          [&](int c, int g) { return szs[(size_t)g * Dqkv + c]; }, y4);
      tile_store(yt, y4);
    }
    for (int j = 0; j < U; ++j) {
      const int u = tile * U + j;
      int p0, p1, ci;
      bool pair_rope;
      qkv_pair(u, 128, a.rd, a.interleaved, P, p0, p1, ci, pair_rope);
      auto row_of = [&](int v) {
        return out_row(v < FT ? p0 : p1, (v / TB) % F);
      };
      float y;
      if constexpr (TC) {
        y = yt[tile_row<TB, F>(lane < 2 * FT ? lane : 0, j, U) * 8 +
               lane % TB];
      } else {
        const int8_t* rows[2] = {pk + (size_t)unit_row<BITS>(p0, tF) * H,
                                 pk + (size_t)unit_row<BITS>(p1, tF) * H};
        y = group_dot_zp<TB, BITS, 2, OPT>(
            rows, H, xs, a.gs, !KMAJ, pf,
            [&](int v, int g) { return bf(sc, (size_t)g * Dqkv + row_of(v)); },
            szs,
            [&](int v, int g) { return szs[(size_t)g * Dqkv + row_of(v)]; },
            (size_t)tF * H);
      }
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
        if (a.qk_nm) {     // normed, roped and stored in phase 3
          a.qkv_f[(size_t)(b0 + b) * Dqkv + row] = yv;
          continue;
        }
      }
      float out = yv;
      if (pair_rope && row < n_rope) {
        const float c = rope_table<GEMMA>(a, a.cos_half,
                                          l)[(size_t)(b0 + b) * a.cos_ld + ci];
        const float sn = rope_table<GEMMA>(a, a.sin_half,
                                           l)[(size_t)(b0 + b) * a.cos_ld + ci];
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
// the block's arrival at counter c, n arrivals at once: thread 0 adds
// them with acquire-release semantics after a block barrier (releasing the
// block's writes, acquiring those of the arrivals before it) and returns
// whether they complete need arrivals, setting the counter back to zero
// then. Block-level; last_s: an int of shared memory.
__device__ __forceinline__ bool arrive(int* c, int n, int need,
                                       int* last_s) {
  __syncthreads();
  if (threadIdx.x == 0) {
    int prev;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], %2;\n"
                 : "=r"(prev) : "l"(c), "r"(n) : "memory");
    *last_s = prev + n == need;
    if (*last_s) *c = 0;
  }
  __syncthreads();
  return *last_s;
}


// A warp per (gate, up) packed row pair of gu_pk [2 I / F, H] (gate tiles,
// then up tiles; tile-major scales gu_gs [G, 2 I]): act(g * sx) * (u * sx)
// into act_a [B, I] and max|a| per (token row, tile) into amax. LORA adds
// xa_g . lb_g[row]^T to gate and up before the activation (lb_g's rows
// tile-major like the scales' columns).
template <int TB, int BITS, bool KMAJ, bool OPT, bool LORA, bool ARCH,
          bool GEMMA = false, bool TCK = false>
__device__ void gphase_gateup(const W8A8Args& a, int l, int8_t* xs, float* pf) {
  constexpr int F = fields<BITS>(), NP = planes<BITS>();
  constexpr int FT = F * TB;
  // TC (the TCK kernel: 4 and 8 bits, batches of token groups): a warp's
  // tile holds U
  // (gate, up) row pairs (warp_tile_dot); otherwise a warp takes one
  // (group_dot)
  constexpr bool TC = TCK && (BITS == 4 || BITS == 8);
  constexpr int U = TC ? 8 / F : 1;
  const int H = a.H, I = a.I, ti = a.ti, ng = I / ti, G = H / a.gs;
  const int tF = ti / F, PI = I / F;
  const int groups = (a.B + TB - 1) / TB, ntiles = PI / U;
  const int W = TC ? tiles_per_block(ntiles * groups) : kWarps;
  const int nrb = (ntiles + W - 1) / W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int8_t* pk = a.gu_pk + (size_t)l * 2 * NP * PI * H;
  const bf16* sc = a.gu_gs + (size_t)l * G * 2 * I;
  const float* szs = a.gu_sz ? a.gu_sz + (size_t)l * G * 2 * I : nullptr;
  const int* perm = a.ap_g ? a.ap_g + (size_t)l * H : nullptr;
  float* yt = pf;                       // TC: the warp's tile sums
  // scale column of field f of unit q's gate (r = 0) or up (r = 1) row
  auto col_of = [&](int q, int r, int f) {
    const int tq = q / tF;
    return (2 * tq + r) * ti + f * tF + (q - tq * tF);
  };
  int staged = -1;
  for (int bu = blockIdx.x; bu < nrb * groups; bu += gridDim.x) {
    const int rb = bu / groups, grp = bu - rb * groups;
    const int b0 = grp * TB, nb = min(TB, a.B - b0);
    if (grp != staged) {
      __syncthreads();
      stage_rows_ord<TB, OPT>(a.x8, perm, b0, nb, H, xs);
      staged = grp;
    }
    const int tile = rb * W + warp;      // TC: the warp's tile; else unit
    if (warp >= W || tile >= ntiles) continue;
    if constexpr (TC) {
      // tile row i < U: the gate row of unit tile U + i; U + i: its up row
      auto prow = [&](int i) {
        return pk + ((size_t)(i < U ? 0 : PI) + tile * U + i % U) * H;
      };
      auto orow = [&](int m) {
        const int i = F == 2 ? m & 7 : m;
        return col_of(tile * U + i % U, i / U, F == 2 ? m >> 3 : 0);
      };
      const int g8 = lane >> 2;
      float y4[4];
      warp_tile_dot_zp<TB, BITS, OPT>(
          prow(g8), prow(F == 2 ? g8 : g8 + 8), orow(g8), orow(g8 + 8), H, xs,
          a.gs, !KMAJ,
          [&](int c, int g) { return bf(sc, (size_t)g * 2 * I + c); }, szs,
          [&](int c, int g) { return szs[(size_t)g * 2 * I + c]; }, y4);
      tile_store(yt, y4);
    }
    for (int j = 0; j < U; ++j) {
      const int p = tile * U + j;
      const int t = p / tF, i = p - t * tF;
      auto col = [&](int v) {
        return (size_t)col_of(p, v / FT, (v / TB) % F);
      };
      float y;
      if constexpr (TC) {
        y = yt[tile_row<TB, F>(lane < 2 * FT ? lane : 0, j, U) * 8 +
               lane % TB];
      } else {
        const int8_t* rows[2] = {
            pk + (size_t)unit_row<BITS>(p, tF) * H,
            pk + (size_t)(NP * PI + unit_row<BITS>(p, tF)) * H};
        y = group_dot_zp<TB, BITS, 2, OPT>(
            rows, H, xs, a.gs, !KMAJ, pf,
            [&](int v, int g) { return bf(sc, (size_t)g * 2 * I + col(v)); },
            szs,
            [&](int v, int g) { return szs[(size_t)g * 2 * I + col(v)]; },
            (size_t)tF * H);
      }
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
}

// ------------------------------------------- kernel 14: row-major o, down
// o_pk [NP H / F, q_dim]: a warp per two output rows at 8 and 4 bits (NR =
// 2 / F packed rows), per packed unit (F rows) at 3 and 2; x[b][n] +=
// (sum_g s_g z_g) * sa[b] for the rows n it owns (a8
// staged from the quantized attention output). LORA adds xa_o . lb_o[n]^T
// to the product before the residual. GEMMA with sandwich norms writes the
// product (bias and EoRA term added) to sand instead, for the norm pass.
template <int TB, int BITS, bool OPT, bool LORA, bool ARCH,
          bool GEMMA = false, bool TCK = false>
__device__ void gphase_o_rows(const W8A8Args& a, int l, int8_t* xs,
                              float* sa_s, float* pf) {
  constexpr int F = fields<BITS>(), NP = planes<BITS>();
  constexpr int FT = F * TB, NR = F == 1 ? 2 : 1, VO = NR * FT;
  // TC (the TCK kernel: 4 and 8 bits, batches of token groups): a warp's
  // tile holds U
  // units of two output rows (warp_tile_dot); otherwise a warp takes one
  // (group_dot)
  constexpr bool TC = TCK && (BITS == 4 || BITS == 8);
  constexpr int U = TC ? 8 : 1;
  const int H = a.H, K = a.q_dim, P = H / F, Gq = K / a.gs;
  const int units = P / NR, groups = (a.B + TB - 1) / TB;
  const int ntiles = units / U;
  const int W = TC ? tiles_per_block(ntiles * groups) : kWarps;
  const int nrb = (ntiles + W - 1) / W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int8_t* pk = a.o_pk + (size_t)l * NP * P * K;
  const bf16* sc = a.o_gs + (size_t)l * Gq * H;
  const float* szs = a.o_sz ? a.o_sz + (size_t)l * Gq * H : nullptr;
  const int* perm = a.ap_o ? a.ap_o + (size_t)l * K : nullptr;
  float* yt = pf;                       // TC: the warp's tile sums
  int staged = -1;
  for (int bu = blockIdx.x; bu < nrb * groups; bu += gridDim.x) {
    const int rb = bu / groups, grp = bu - rb * groups;
    const int b0 = grp * TB, nb = min(TB, a.B - b0);
    if (grp != staged) {
      __syncthreads();
      if (threadIdx.x < TB)
        sa_s[threadIdx.x] =
            (int)threadIdx.x < nb ? attn_scale(a, b0 + threadIdx.x) : 1.f;
      __syncthreads();
      stage_quant<TB, OPT>(a.attn, K, perm, 0, b0, nb, K, sa_s, xs);
      staged = grp;
    }
    const int tile = rb * W + warp;      // TC: the warp's tile; else unit
    if (warp >= W || tile >= ntiles) continue;
    if constexpr (TC) {
      // tile row i: packed row NR U tile + i (8 bits) or its fields (4)
      const int p0 = NR * U * tile, g8 = lane >> 2;
      auto orow = [&](int m) {
        return F == 2 ? (m >> 3) * P + p0 + (m & 7) : p0 + m;
      };
      float y4[4];
      warp_tile_dot_zp<TB, BITS, OPT>(
          pk + (size_t)(p0 + g8) * K,
          pk + (size_t)(p0 + (F == 2 ? g8 : g8 + 8)) * K, orow(g8),
          orow(g8 + 8), K, xs, a.gs, true,
          [&](int c, int g) { return bf(sc, (size_t)g * H + c); }, szs,
          [&](int c, int g) { return szs[(size_t)g * H + c]; }, y4);
      tile_store(yt, y4);
    }
    for (int j = 0; j < U; ++j) {
      const int u = tile * U + j;
      auto row_of = [&](int v) {
        return ((v / TB) % F) * P + NR * u + v / FT;
      };
      float y;
      if constexpr (TC) {
        y = yt[tile_row<TB, F>(lane < VO ? lane : 0, NR * j, 1) * 8 +
               lane % TB];
      } else {
        const int8_t* rows[NR];
#pragma unroll
        for (int r = 0; r < NR; ++r) rows[r] = pk + (size_t)(NR * u + r) * K;
        y = group_dot_zp<TB, BITS, NR, OPT>(
            rows, K, xs, a.gs, true, pf,
            [&](int v, int g) { return bf(sc, (size_t)g * H + row_of(v)); },
            szs, [&](int v, int g) { return szs[(size_t)g * H + row_of(v)]; },
            (size_t)P * K);
      }
      float lora = 0.f;
      const bool with_lora = lora_on<LORA, GEMMA>(a);
      if (with_lora)
        lora = lora_out<VO>(
            a.r_o,
            [&](int v) {
              return v % TB < nb ? a.xa_o + (size_t)(b0 + v % TB) * a.r_o
                                 : nullptr;
            },
            [&](int v) {
              return a.lb_o + ((size_t)l * H + row_of(v)) * a.r_o;
            });
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
}

// dn_pk [NP H / F, I]: a warp per two output rows (per unit at 3 and 2
// bits, as o) walks the MLP tiles in
// order, ma += (sum over the tile's groups of s_g z_g) * sa_t, then adds ma
// to the residual rows it owns (a8 staged per tile from the quantized
// activation; dn_gs [NG * gtp, H], each tile's groups padded to gtp rows).
// LORA adds xa_d . lb_d[n]^T to ma before the residual; GEMMA with
// sandwich norms writes ma to sand instead, for the norm pass.
template <int TB, int BITS, bool OPT, bool LORA, bool ARCH,
          bool GEMMA = false, bool TCK = false>
__device__ void gphase_down_rows(const W8A8Args& a, int l, int8_t* xs,
                                 float* sa_s, float* pf) {
  constexpr int F = fields<BITS>(), NP = planes<BITS>();
  constexpr int FT = F * TB, NR = F == 1 ? 2 : 1, VO = NR * FT;
  // TC (the TCK kernel: 4 and 8 bits, batches of token groups): a warp's
  // tile holds U
  // units of two output rows (warp_tile_dot); otherwise a warp takes one
  // (group_dot)
  constexpr bool TC = TCK && (BITS == 4 || BITS == 8);
  constexpr int U = TC ? 8 : 1;
  const int H = a.H, I = a.I, ti = a.ti, ng = I / ti, P = H / F;
  const int units = P / NR, groups = (a.B + TB - 1) / TB;
  const int ntiles = units / U;
  const int W = TC ? tiles_per_block(ntiles * groups) : kWarps;
  const int nrb = (ntiles + W - 1) / W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int8_t* pk = a.dn_pk + (size_t)l * NP * P * I;
  const bf16* sc = a.dn_gs + (size_t)l * ng * a.gtp * H;
  const float* szs = a.dn_sz ? a.dn_sz + (size_t)l * ng * a.gtp * H : nullptr;
  float* yt = pf;                       // TC: the warp's tile sums
  for (int bu = blockIdx.x; bu < nrb * groups; bu += gridDim.x) {
    const int rb = bu / groups, grp = bu - rb * groups;
    const int b0 = grp * TB, nb = min(TB, a.B - b0);
    const int tile = rb * W + warp;      // TC: the warp's tile; else unit
    const bool busy = warp < W && tile < ntiles;
    // TC: the tile's sums of (rows g, g + 8) x (tokens 2 t, 2 t + 1);
    // otherwise lane v's
    float ma[4] = {0.f, 0.f, 0.f, 0.f};
    for (int t = 0; t < ng; ++t) {
      __syncthreads();
      if (threadIdx.x < TB)
        sa_s[threadIdx.x] = (int)threadIdx.x < nb
                                ? tile_scale(a.amax, b0 + threadIdx.x, ng, t)
                                : 1.f;
      if constexpr (TB == 1) {    // no int8 pass at one token row
        __syncthreads();
        stage_quant<TB, false>(a.act_a, I, nullptr, t * ti, b0, nb, ti, sa_s,
                               xs);
      } else {
        stage_rows_ld<TB>(a.a8, I, t * ti, b0, nb, ti, xs);
      }
      if (!busy) continue;
      if constexpr (TC) {
        const int p0 = NR * U * tile, g8 = lane >> 2, t4 = lane & 3;
        auto orow = [&](int m) {
          return F == 2 ? (m >> 3) * P + p0 + (m & 7) : p0 + m;
        };
        float y4[4];
        warp_tile_dot_zp<TB, BITS, OPT>(
            pk + (size_t)(p0 + g8) * I + (size_t)t * ti,
            pk + (size_t)(p0 + (F == 2 ? g8 : g8 + 8)) * I + (size_t)t * ti,
            orow(g8), orow(g8 + 8), ti, xs, a.gs, true,
            [&](int c, int g) {
              return bf(sc, (size_t)(t * a.gtp + g) * H + c);
            },
            szs, [&](int c, int g) {
              return szs[(size_t)(t * a.gtp + g) * H + c];
            }, y4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ma[e] = __fadd_rn(ma[e],
                            __fmul_rn(y4[e], sa_s[(2 * t4 + (e & 1)) % TB]));
      } else {
        const int u = tile;
        auto row_of = [&](int v) {
          return ((v / TB) % F) * P + NR * u + v / FT;
        };
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
          ma[0] = __fadd_rn(ma[0], __fmul_rn(y, sa_s[lane % TB]));
      }
    }
    if (!busy) continue;
    if constexpr (TC) tile_store(yt, ma);
    for (int j = 0; j < U; ++j) {
      const int u = tile * U + j;
      auto row_of = [&](int v) {
        return ((v / TB) % F) * P + NR * u + v / FT;
      };
      float m0 = ma[0];
      if constexpr (TC)
        m0 = yt[tile_row<TB, F>(lane < VO ? lane : 0, NR * j, 1) * 8 +
                lane % TB];
      float lora = 0.f;
      const bool with_lora = lora_on<LORA, GEMMA>(a);
      if (with_lora)
        lora = lora_out<VO>(
            a.r_d,
            [&](int v) {
              return v % TB < nb ? a.xa_d + (size_t)(b0 + v % TB) * a.r_d
                                 : nullptr;
            },
            [&](int v) {
              return a.lb_d + ((size_t)l * H + row_of(v)) * a.r_d;
            });
      const int b = lane % TB;
      if (lane >= VO || b >= nb) continue;
      if (with_lora) m0 = __fadd_rn(m0, lora);
      if constexpr (ARCH) {
        if (a.dn_bias)
          m0 = __fadd_rn(m0, a.dn_bias[(size_t)l * H + row_of(lane)]);
      }
      if constexpr (GEMMA) {
        if (a.pm_norm) {
          a.sand[(size_t)(b0 + b) * H + row_of(lane)] = m0;
          continue;
        }
      }
      float* xr = a.xs + (size_t)(b0 + b) * H + row_of(lane);
      *xr = __fadd_rn(*xr, m0);
    }
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
      __syncthreads();
      stage_quant<TB, false>(a.attn, K, nullptr, 0, b0, nb, K, sa_s, xs);
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
// columns), a thread per 4 byte columns; the group's int8 activations from
// a8 [B, lda] or, where src is given, quantized as they are staged from
// the float32 src [B, lda] with the scale sc(b, g) (B <= TB). srow(g): the
// group's bf16 scale row of N.
template <int TB, typename Sc, typename Srow>
__device__ void gphase_kmajor(const W8A8Args& a, const int8_t* pk, int K,
                              int N, const float* src, int lda, Sc sc,
                              int* a8w, Srow srow) {
  const int N2 = N / 2, gs = a.gs, gw = gs / 4;
  const int ngr = K / gs, nn = (N2 + kNCols - 1) / kNCols;
  for (int un = blockIdx.x; un < ngr * nn; un += gridDim.x) {
    const int g = un / nn, c0 = (un - g * nn) * kNCols + 4 * threadIdx.x;
    __syncthreads();
    for (int e = threadIdx.x; e < TB * gw; e += kThreads) {
      const int b = e / gw, w = e - b * gw;
      const size_t o = (size_t)b * lda + (size_t)g * gs + 4 * w;
      unsigned v = 0;
      if (b < a.B && src) {
        const float4 f = *reinterpret_cast<const float4*>(src + o);
        const float sb = sc(b, g);
        v = (unsigned)(quant8(f.x, sb) & 0xff) |
            ((unsigned)(quant8(f.y, sb) & 0xff) << 8) |
            ((unsigned)(quant8(f.z, sb) & 0xff) << 16) |
            ((unsigned)(quant8(f.w, sb) & 0xff) << 24);
      } else if (b < a.B) {
        v = *reinterpret_cast<const unsigned*>(a.a8 + o);
      }
      a8w[e] = (int)v;
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

// Kernel 13's elementwise pass elem(e) over the B x H residual (its sums of
// group partials), in units of (token row, kThreads columns) spread over
// the grid; the last unit of a row to finish forms the row's norm (weight
// nw) and int8 row (counters att_count[B Hkv + b]), so that the sums and
// the norm share one barrier. red: kWarps floats, last_s: an int of shared
// memory.
template <typename Elem>
__device__ void kmajor_rows_norm(const W8A8Args& a, Elem elem,
                                 const float* nw, float* red, int* last_s) {
  const int H = a.H, S = (H + kThreads - 1) / kThreads;
  const int BG = a.B * (a.kv_dim / a.d);
  for (int u = blockIdx.x; u < a.B * S; u += gridDim.x) {
    const int b = u / S, k = (u - b * S) * kThreads + threadIdx.x;
    if (k < H) elem((size_t)b * H + k);
    if (arrive(a.att_count + BG + b, 1, S, last_s)) {
      row_norm_quant<float>(a.xs + (size_t)b * H, H, H, nw, a.eps,
                            a.rms_offset, a.x8 + (size_t)b * H, a.sx + b,
                            red);
    }
  }
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

// ------------------------------------- kernels 13 and 14: the attention
// One (token row b, kv head g) unit of the TPU kernels walks its key
// history in flash blocks of Tb keys from key 0 (a sliding layer's first
// block from its window's first key to the next multiple of Tb), with a
// running max per block. Here every block of every unit is a work item of
// its own, so that the grid's blocks share the phase: at batch 1 and 160
// keys, 8 kv heads give 16 items (the former walk kept 8 blocks busy, each
// running four barrier-separated stages a key block). An item:
//
// * copies its block's K and V rows (at most kAttnKeys, Tb <= 128) into
//   shared memory with cp.async, all in flight at once (K before V): keys
//   at or past pos are never read; and beside them the unit's query heads
//   and the current token's k and v (this step's, in the qkv row);
// * scores them, a thread per key and head parity, each score an FMA chain
//   over the dims in order, scaled and (gemma2) softcapped in float32;
// * takes its block max per head and publishes it (att_part, then a flag
//   with release semantics); the maxima are order-free, so the running max
//   m_j of a walk from key 0 is the max of this block's and of the earlier
//   blocks' published maxima, which the item waits for (acquire). An item
//   waits only on items of the same unit with a smaller block index, which
//   the grid enumerates first (index = block * B Hkv + unit) and every
//   block walks in increasing order, all of them resident (a cooperative
//   launch): the earliest unfinished item waits on nothing, so the waits
//   end;
// * forms p = exp(s - m_j), the float32 sum l_j of p and, with p rounded to
//   bf16, pv_j = p . v (a warp per eighth of the keys in key order, the
//   eighths added in order): the TPU kernel's rounding points, and the
//   float order of the one-block walk that kernels 13-14 ran before, which
//   the plain version (``flash_rows``) reproduces bit for bit at one token
//   row (tensor-core products here moved scores by an ulp, flipped p's
//   bf16 roundings, and a sandwich norm carried that to y);
// * leaves pv_j, l_j in att_part and arrives at its unit's counter. The
//   last item to arrive combines in block order, acc = acc a_j + pv_j and
//   l = l a_j + l_j with a_j = exp(m_{j-1} - m_j) (the walk's rescale
//   chain), folds the current token in last, writes a = acc / l and the
//   unit's max|a| (attn_amax), and sets the unit's counter and flags back to
//   zero for the next layer and call.
//
// No float is summed across blocks but in this fixed order, so nothing
// depends on the order the blocks run in. With qwen3's qk-norm (ARCH) each
// item first norms, ropes and stores its unit's heads (qk_norm_rope_heads:
// every item of a unit writes the same values).
constexpr int kAttnKeys = 128;                    // keys of an item at most
static_assert(kThreads == 2 * kAttnKeys, "a thread per key and head parity");
constexpr int kAttnPitch = 2 * 128 + 16;          // bytes of a K, V or q row
constexpr int kAttnSPitch = kAttnKeys + 4;        // floats of a head's scores
constexpr int kAttnPPitch = 2 * kAttnKeys + 16;   // bytes of a head's bf16 p
constexpr unsigned kAttnSpins = 1u << 28;         // polls of a flag at most
// shared memory of the attention phase: K and V rows, q (heads padded to
// 8) and the current token's k and v, the scores, p and the item's small
// state
constexpr size_t kGAttnBytes =
    2 * (size_t)kAttnKeys * kAttnPitch + (kMaxQpk + 2) * kAttnPitch +
    sizeof(float) * kMaxQpk * kAttnSPitch + kMaxQpk * kAttnPPitch +
    sizeof(float) * 64;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

// the flash blocks of a row at position pos in layer l: j0 .. j1 - 1
// (blocks of Tb keys from key 0; one, empty, where the row has no key to
// read) and the first key t_lo (GEMMA: a sliding window's)
template <bool GEMMA>
__device__ __forceinline__ void attn_blocks(const W8A8Args& a, int l,
                                            int pos, int& j0, int& j1,
                                            int& t_lo) {
  t_lo = 0;
  if constexpr (GEMMA) {
    if (a.windows) t_lo = max(0, pos - a.windows[l] + 1);
  }
  j0 = t_lo / a.Tb;
  j1 = max(j0 + 1, (pos + a.Tb - 1) / a.Tb);
}

template <bool ARCH, bool GEMMA>
__device__ void gphase_attention(const W8A8Args& a, int l, unsigned char* sm,
                                 const int* pos_s) {
  constexpr int d = 128;
  const int Hkv = a.kv_dim / d, qpk = a.q_dim / d / Hkv, Tb = a.Tb;
  const int Dqkv = a.q_dim + 2 * a.kv_dim, NJ = a.T / Tb, BG = a.B * Hkv;
  const int stride = qpk * (d + 2);         // floats of an item's partials
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float cap = GEMMA ? a.softcap : 0.f;
  const float inv_cap = cap != 0.f ? 1.f / cap : 0.f;
  unsigned char* k_s = sm;
  unsigned char* v_s = k_s + kAttnKeys * kAttnPitch;
  unsigned char* q_s = v_s + kAttnKeys * kAttnPitch;
  // the current token's k and v rows (this step's, in the qkv row)
  const bf16* kc_s = reinterpret_cast<const bf16*>(q_s + kMaxQpk * kAttnPitch);
  const bf16* vc_s = kc_s + kAttnPitch / 2;
  float* s_s = reinterpret_cast<float*>(q_s + (kMaxQpk + 2) * kAttnPitch);
  unsigned char* p_s =
      reinterpret_cast<unsigned char*>(s_s + kMaxQpk * kAttnSPitch);
  float* m_s = reinterpret_cast<float*>(p_s + kMaxQpk * kAttnPPitch);
  float* mx_s = m_s + 8;       // this block's max per head
  float* l_s = m_s + 16;       // this block's sum of p per head
  float* pc_s = m_s + 24;      // the current token's score per head
  float* red = m_s + 32;       // block_max
  int* last_s = reinterpret_cast<int*>(m_s + 40);
  int nj = 1;                  // blocks of the longest row
  for (int b = 0; b < a.B; ++b) {
    int j0, j1, t_lo;
    attn_blocks<GEMMA>(a, l, pos_s[b], j0, j1, t_lo);
    nj = max(nj, j1 - j0);
  }
  for (int u = blockIdx.x; u < nj * BG; u += gridDim.x) {
    const int jj = u / BG, bg = u - jj * BG;
    const int b = bg / Hkv, g = bg - b * Hkv;
    int j0, j1, t_lo;
    const int pos = pos_s[b];
    attn_blocks<GEMMA>(a, l, pos, j0, j1, t_lo);
    if (jj >= j1 - j0) continue;              // uniform across the block
    const int j = j0 + jj;
    const int ta = max(j * Tb, t_lo);
    const int nk = max(0, min((j + 1) * Tb, pos) - ta);
    float* part = a.att_part + ((size_t)bg * NJ + j) * stride;
    const bf16* row = a.qkv_out + (size_t)b * Dqkv;
    __syncthreads();                          // the last item's smem is read
    if constexpr (ARCH) {
      if (a.qk_nm)
        qk_norm_rope_heads<GEMMA>(a, l, b, g, reinterpret_cast<float*>(k_s));
    }
    const size_t off = (size_t)l * a.cache_sl + (size_t)b * a.cache_sb +
                       (size_t)g * a.cache_sg;
#pragma unroll
    for (int kv = 0; kv < 2; ++kv) {          // K, then V: a group each
      const bf16* src = (kv ? a.v_cache : a.k_cache) + off;
      unsigned char* dst = kv ? v_s : k_s;
      for (int e = tid; e < nk * 16; e += kThreads) {
        const int r = e >> 4, c = e & 15;
        cp_async16(dst + r * kAttnPitch + c * 16,
                   src + (size_t)(ta + r) * a.cache_st + c * 8, true);
      }
      cp_async_commit();
    }
    // the unit's query heads (padding heads zero), then the current
    // token's k and v heads
    for (int e = tid; e < (kMaxQpk + 2) * 16; e += kThreads) {
      const int h = e >> 4, c = e & 15;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (h < qpk)
        v = *reinterpret_cast<const uint4*>(row + (g * qpk + h) * d + c * 8);
      else if (h >= kMaxQpk)
        v = *reinterpret_cast<const uint4*>(
            row + a.q_dim + (h - kMaxQpk) * a.kv_dim + g * d + c * 8);
      *reinterpret_cast<uint4*>(q_s + h * kAttnPitch + c * 16) = v;
    }
    cp_async_wait<1>();                       // K landed
    __syncthreads();
    // scores: a thread per key and head parity, each (key, head) an FMA
    // chain over the 128 dims in order, the walk's float order (a score a
    // float ulp off flips p's bf16 rounding, and a sandwich norm carries
    // that to every later layer)
    {
      const int t = tid % kAttnKeys, hp = tid / kAttnKeys;
      if (t < nk) {
        const unsigned char* kr = k_s + t * kAttnPitch;
        float sc[kMaxQpk / 2];
#pragma unroll
        for (int i = 0; i < kMaxQpk / 2; ++i) sc[i] = 0.f;
#pragma unroll 2
        for (int c = 0; c < d; c += 8) {
          const uint4 kw = *reinterpret_cast<const uint4*>(kr + 2 * c);
          float kv[8];
          bf16x4(make_uint2(kw.x, kw.y), kv);
          bf16x4(make_uint2(kw.z, kw.w), kv + 4);
#pragma unroll
          for (int i = 0; i < kMaxQpk / 2; ++i) {
            if (hp + 2 * i >= qpk) break;
            const uint4 qw = *reinterpret_cast<const uint4*>(
                q_s + (hp + 2 * i) * kAttnPitch + 2 * c);
            float qv[8];
            bf16x4(make_uint2(qw.x, qw.y), qv);
            bf16x4(make_uint2(qw.z, qw.w), qv + 4);
#pragma unroll
            for (int e = 0; e < 8; ++e) sc[i] = fmaf(qv[e], kv[e], sc[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < kMaxQpk / 2; ++i) {
          if (hp + 2 * i >= qpk) break;
          float v = sc[i] * a.scale;
          if constexpr (GEMMA)
            if (cap != 0.f) v = soft_cap(v, cap, inv_cap);
          s_s[(hp + 2 * i) * kAttnSPitch + t] = v;
        }
      }
    }
    __syncthreads();
    // the block's max per head, published; and the current token's score
    // per head, which the unit's last item folds in last
    for (int h = warp; h < qpk; h += kWarps) {
      float mx = -1e30f;
      for (int t = lane; t < nk; t += 32)
        mx = fmaxf(mx, s_s[h * kAttnSPitch + t]);
      mx = warp_max(mx);
      if (lane == 0) mx_s[h] = mx;
      const bf16* qh = reinterpret_cast<const bf16*>(q_s + h * kAttnPitch);
      float p = 0.f;
      for (int e = lane; e < d; e += 32)
        p = fmaf(__bfloat162float(qh[e]), __bfloat162float(kc_s[e]), p);
      p = warp_sum(p) * a.scale;
      if constexpr (GEMMA)
        if (cap != 0.f) p = soft_cap(p, cap, inv_cap);
      if (lane == 0) pc_s[h] = p;
    }
    __syncthreads();
    // (warp 1 publishes, so that warp 0 does not wait on the release)
    if (tid == 32) {
      for (int h = 0; h < qpk; ++h) part[qpk * d + qpk + h] = mx_s[h];
      st_release(a.att_flag + (size_t)bg * NJ + j, 1);
    }
    // m_j: the max of the earlier blocks' maxima and this block's
    if (warp == 0) {
      float mp[kMaxQpk];
#pragma unroll
      for (int h = 0; h < kMaxQpk; ++h) mp[h] = -1e30f;
      for (int jp = j0 + lane; jp < j; jp += 32) {
        const size_t s = (size_t)bg * NJ + jp;
        // an earlier block's max comes within microseconds; one that never
        // came (flags or operands out of step) ends the launch with an
        // error after seconds rather than hanging the card
        for (unsigned spins = 0; ld_acquire(a.att_flag + s) == 0; ++spins)
          if (spins == kAttnSpins) __trap();
        const float* pm = a.att_part + s * stride + qpk * d + qpk;
#pragma unroll
        for (int h = 0; h < kMaxQpk; ++h)
          if (h < qpk) mp[h] = fmaxf(mp[h], __ldcg(pm + h));
      }
#pragma unroll
      for (int h = 0; h < kMaxQpk; ++h) {
        const float m = warp_max(mp[h]);
        if (lane == 0 && h < qpk) m_s[h] = fmaxf(m, mx_s[h]);
      }
    }
    __syncthreads();
    // p = exp(s - m_j) rounded to bf16 for p . v; l_j sums the unrounded p
    for (int h = warp; h < qpk; h += kWarps) {
      const float m = m_s[h];
      bf16* ph = reinterpret_cast<bf16*>(p_s + h * kAttnPPitch);
      float sum = 0.f;
      for (int t = lane; t < nk; t += 32) {
        const float p = expf(s_s[h * kAttnSPitch + t] - m);
        ph[t] = __float2bfloat16(p);
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) l_s[h] = sum;
    }
    cp_async_wait<0>();                       // V landed
    __syncthreads();
    // p . v in the walk's float order: warp w takes the keys w per ..
    // (w + 1) per - 1 (per = ceil(nk / 8)) in key order for dims 4 lane ..
    // 4 lane + 3, and warp 0 adds the warps' sums in warp order (the K rows'
    // shared memory holds them)
    {
      static_assert(kPvParts == kWarps, "a warp per key part");
      const int per = (nk + kWarps - 1) / kWarps, lo = warp * per;
      const int hi = min(nk, lo + per);
      float pv[kMaxQpk][4];
#pragma unroll
      for (int h = 0; h < kMaxQpk; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[h][i] = 0.f;
      for (int t = lo; t < hi; ++t) {
        float v[4];
        bf16x4(*reinterpret_cast<const uint2*>(v_s + t * kAttnPitch +
                                               8 * lane), v);
#pragma unroll
        for (int h = 0; h < kMaxQpk; ++h)
          if (h < qpk) {
            const float pr = __bfloat162float(
                reinterpret_cast<const bf16*>(p_s + h * kAttnPPitch)[t]);
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[h][i] = fmaf(pr, v[i], pv[h][i]);
          }
      }
      float* pvq = reinterpret_cast<float*>(k_s);   // [warps 1..7][qpk][d]
      if (warp) {
#pragma unroll
        for (int h = 0; h < kMaxQpk; ++h)
          if (h < qpk)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              pvq[((warp - 1) * kMaxQpk + h) * d + 4 * lane + i] = pv[h][i];
      }
      __syncthreads();
      if (warp == 0) {
#pragma unroll
        for (int h = 0; h < kMaxQpk; ++h)
          if (h < qpk)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float sum = pv[h][i];
              for (int r = 0; r < kWarps - 1; ++r)
                sum += pvq[(r * kMaxQpk + h) * d + 4 * lane + i];
              part[h * d + 4 * lane + i] = sum;
            }
      }
    }
    if (tid < qpk) part[qpk * d + tid] = l_s[tid];
    // the last item of the unit to arrive combines
    if (!arrive(a.att_count + bg, 1, j1 - j0, last_s)) continue;
    float amax = 0.f;
    for (int o = tid; o < qpk * d; o += kThreads) {
      const int h = o / d, e = o - h * d;
      float m = -1e30f, acc = 0.f, ls = 0.f;
      // the blocks in order, four blocks' partials loaded at once
      for (int jq = j0; jq < j1; jq += 4) {
        float mj[4], pj[4], lj[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float* pp =
              a.att_part + ((size_t)bg * NJ + min(jq + i, j1 - 1)) * stride;
          mj[i] = __ldcg(pp + qpk * d + qpk + h);
          pj[i] = __ldcg(pp + o);
          lj[i] = __ldcg(pp + qpk * d + h);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (jq + i >= j1) break;
          const float m_new = fmaxf(m, mj[i]);
          const float al = expf(m - m_new);
          acc = __fadd_rn(__fmul_rn(acc, al), pj[i]);
          ls = __fadd_rn(__fmul_rn(ls, al), lj[i]);
          m = m_new;
        }
      }
      const float pc = pc_s[h];
      const float m_new = fmaxf(m, pc);
      const float al = expf(m - m_new);
      const float pe = expf(pc - m_new);
      ls = __fadd_rn(__fmul_rn(ls, al), pe);
      const float out =
          __fadd_rn(__fmul_rn(acc, al),
                    __fmul_rn(bf16r(pe), __bfloat162float(vc_s[e]))) /
          fmaxf(ls, 1e-30f);
      a.attn[(size_t)b * a.q_dim + (g * qpk + h) * d + e] = out;
      amax = fmaxf(amax, fabsf(out));
    }
    amax = block_max(amax, red);
    if (tid == 0) a.attn_amax[bg] = amax;
    for (int jp = j0 + tid; jp < j1; jp += kThreads)
      a.att_flag[(size_t)bg * NJ + jp] = 0;   // ready for the next layer
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
          bool ARCH, bool GEMMA = false, bool TCK = false>
__global__ void __launch_bounds__(kThreads, 2)
    grouped_megastep_kernel(W8A8Args a) {
  static_assert(!(LORA && KMAJ), "the EoRA epilogue is kernel 14's");
  static_assert(!(ARCH && KMAJ), "qk-norm and biases are kernel 14's");
  static_assert(!(GEMMA && KMAJ), "gemma's operands are kernel 14's");
  const bool with_lora = lora_on<LORA, GEMMA>(a);
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  // a warp's own slab: the dp4a walks' group partials, or its tile's sums
  // (warp_tile_dot, 128 floats)
  constexpr int kPf = pf_floats<TB, BITS>();
  static_assert(TB != kGroupTB || kPf >= 128, "a tile's sums fit a slab");
  float* pf = reinterpret_cast<float*>(smem + kHeadBytes) +
              (threadIdx.x >> 5) * kPf;
  unsigned char* work = smem + kHeadBytes + kWarps * kPf * sizeof(float);
  float* sa_s = reinterpret_cast<float*>(work);
  int8_t* xs_s = reinterpret_cast<int8_t*>(work + kSaBytes);
  // the Walsh walks' integer partials, one 1024-int slab a warp
  int* wred = reinterpret_cast<int*>(smem + kHeadBytes);
  // an arrival's verdict (red's first kWarps floats serve block_sum/max)
  int* last_s = reinterpret_cast<int*>(red + kWarps);
  // the rows' positions, read once (B <= 64)
  __shared__ int pos_s[64];
  for (int b = threadIdx.x; b < a.B; b += kThreads) pos_s[b] = a.pos[b];
  __syncthreads();
  const int H = a.H, I = a.I, ng = I / a.ti;
  const size_t tid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t nthreads = (size_t)gridDim.x * kThreads;
  const size_t BH = (size_t)a.B * H;

  for (int l = 0; l < a.L; ++l) {
    // GEMMA with the EoRA epilogue: the previous layer's post-MLP sandwich
    // norm into the residual before a barrier (the A product of phase 1
    // reads every row)
    bool sand_m = false;
    if constexpr (GEMMA) {
      sand_m = l > 0 && a.pm_norm != nullptr;
      if (sand_m && with_lora) {
        for (int b = blockIdx.x; b < a.B; b += gridDim.x)
          sandwich_row(a, b, a.pm_norm + (size_t)(l - 1) * H, nullptr, red);
        grid.sync();
        sand_m = false;
      }
    }
    // 1: the layer's entry into the residual row (the input at layer 0;
    // GEMMA the previous layer's post-MLP sandwich norm), then the
    // attention norm and int8 rows: a block per token row; kernel 13 adds
    // the previous layer's MLP from its group partials over the grid, the
    // last unit of a row forming its norm (kmajor_rows_norm)
    if (KMAJ && l > 0) {
      kmajor_rows_norm(a, [&](size_t e) { kmajor_mlp_residual(a, e); },
                       a.attn_norm + (size_t)l * H, red, last_s);
    } else {
      for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
        float* xr = a.xs + (size_t)b * H;
        if (l == 0) {
          for (int k = threadIdx.x; k < H; k += kThreads)
            xr[k] = static_cast<const float*>(a.x)[(size_t)b * H + k];
          __syncthreads();
        } else if (sand_m) {
          sandwich_row(a, b, a.pm_norm + (size_t)(l - 1) * H, nullptr, red);
        }
        row_norm_quant<float>(xr, H, H, a.attn_norm + (size_t)l * H, a.eps,
                              a.rms_offset, a.x8 + (size_t)b * H, a.sx + b,
                              red);
      }
    }
    if (with_lora)   // at layer 0 from the input, which the rows copy
      lora_xa(a, l == 0 ? static_cast<const float*>(a.x) : a.xs, H, H,
              a.ap_q ? a.ap_q + (size_t)l * H : nullptr,
              a.attn_norm + (size_t)l * H, a.la_q + (size_t)l * a.r_q * H,
              a.r_q, a.xa_q, reinterpret_cast<float*>(xs_s));
    grid.sync();
    // 2: qkv + rope; zero the MLP tile maxima
    for (size_t e = tid; e < (size_t)a.B * ng; e += nthreads) a.amax[e] = 0;
    if constexpr (BITS == kWalsh)
      wphase_qkv<LORA, ARCH, GEMMA>(a, l, xs_s, wred);
    else
      gphase_qkv<TB, BITS, KMAJ, OPT, LORA, ARCH, GEMMA, TCK>(a, l, xs_s,
                                                               pf);
    grid.sync();
    // 3: attention, an item per (flash block, token row, kv head)
    // (gphase_attention; with qk-norm each item norms and ropes its heads
    // first; GEMMA: the layer's window and the softcap)
    gphase_attention<ARCH, GEMMA>(a, l, smem, pos_s);
    grid.sync();
    // (o forms the attention output's int8 rows as it stages them; the
    // EoRA epilogue's A product of the float output needs a barrier before
    // o's rows read it)
    if (with_lora) {
      lora_xa(a, a.attn, a.q_dim, a.q_dim,
              a.ap_o ? a.ap_o + (size_t)l * a.q_dim : nullptr, nullptr,
              a.la_o + (size_t)l * a.r_o * a.q_dim, a.r_o, a.xa_o,
              reinterpret_cast<float*>(xs_s));
      grid.sync();
    }
    // 4: o (kernel 13: group partials, summed in group order by the rows
    // of phase 5)
    if constexpr (KMAJ) {
      const int Gq = a.q_dim / a.gs;
      const bf16* os = a.o_gs + (size_t)l * Gq * H;
      if (threadIdx.x < TB)
        sa_s[threadIdx.x] =
            (int)threadIdx.x < a.B ? attn_scale(a, threadIdx.x) : 1.f;
      gphase_kmajor<TB>(a, a.o_pk + (size_t)l * a.q_dim * (H / 2), a.q_dim,
                        H, a.attn, a.q_dim,
                        [&](int b, int) { return sa_s[b]; },
                        reinterpret_cast<int*>(xs_s),
                        [&](int g) { return os + (size_t)g * H; });
    } else if constexpr (BITS == kWalsh) {
      wphase_o<LORA, ARCH, GEMMA>(a, l, xs_s, sa_s, wred);
    } else {
      gphase_o_rows<TB, BITS, OPT, LORA, ARCH, GEMMA, TCK>(a, l, xs_s, sa_s,
                                                           pf);
    }
    grid.sync();
    // 5: GEMMA's post-attention sandwich norm into the residual, then the
    // MLP norm and int8 rows: a block per row, except with the EoRA
    // epilogue, whose A product reads every row (a barrier between);
    // kernel 13 first adds its o partials in group order over the grid,
    // the last unit of a row forming its norm (kmajor_rows_norm)
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
    if constexpr (KMAJ) {
      const int Gq = a.q_dim / a.gs;
      kmajor_rows_norm(a, [&](size_t e) {
        const int b = (int)(e / H), n = (int)(e % H);
        float y = 0.f;
        for (int g = 0; g < Gq; ++g)
          y = __fadd_rn(y, a.partf[((size_t)g * a.B + b) * H + n]);
        a.xs[e] = __fadd_rn(a.xs[e], __fmul_rn(y, attn_scale(a, b)));
      }, a.mlp_norm + (size_t)l * H, red, last_s);
    } else {
      for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
        if (sand_a)
          sandwich_row(a, b, a.pa_norm + (size_t)l * H, nullptr, red);
        row_norm_quant<float>(a.xs + (size_t)b * H, H, H,
                              a.mlp_norm + (size_t)l * H, a.eps,
                              a.rms_offset, a.x8 + (size_t)b * H, a.sx + b,
                              red);
      }
    }
    if (with_lora)
      lora_xa(a, a.xs, H, H, a.ap_g ? a.ap_g + (size_t)l * H : nullptr,
              a.mlp_norm + (size_t)l * H, a.la_g + (size_t)l * a.r_g * H,
              a.r_g, a.xa_g, reinterpret_cast<float*>(xs_s));
    grid.sync();
    // 6: gate/up
    if constexpr (BITS == kWalsh)
      wphase_gateup<LORA, ARCH, GEMMA>(a, l, xs_s, wred);
    else
      gphase_gateup<TB, BITS, KMAJ, OPT, LORA, ARCH, GEMMA, TCK>(a, l, xs_s,
                                                                  pf);
    grid.sync();
    // the activation's int8 rows per MLP tile: at one token row down forms
    // them as it stages them; otherwise a pass with a barrier of its own,
    // which the EoRA epilogue's A product of the float activation shares
    if (TB > 1 || with_lora) {
      if constexpr (TB > 1) {
        for (size_t e = tid; e < (size_t)a.B * I; e += nthreads) {
          const int b = (int)(e / I), m = (int)(e % I);
          a.a8[e] = (int8_t)quant8(a.act_a[e],
                                   tile_scale(a.amax, b, ng, m / a.ti));
        }
      }
      if (with_lora)
        lora_xa(a, a.act_a, I, a.ti, nullptr, nullptr,
                a.la_d + (size_t)l * a.r_d * I, a.r_d, a.xa_d,
                reinterpret_cast<float*>(xs_s));
      grid.sync();
    }
    // 7: down
    if constexpr (KMAJ) {
      const bf16* ds = a.dn_gs + (size_t)l * ng * a.gtp * H;
      const int gti = a.ti / a.gs;
      gphase_kmajor<TB>(
          a, a.dn_pk + (size_t)l * I * (H / 2), I, H,
          TB == 1 ? a.act_a : nullptr, I,
          [&](int b, int g) { return tile_scale(a.amax, b, ng, g / gti); },
          reinterpret_cast<int*>(xs_s), [&](int g) {
            return ds + (size_t)((g / gti) * a.gtp + g % gti) * H;
          });
    } else if constexpr (BITS == kWalsh) {
      wphase_down<LORA, ARCH, GEMMA>(a, l, xs_s, sa_s, wred);
    } else {
      gphase_down_rows<TB, BITS, OPT, LORA, ARCH, GEMMA, TCK>(a, l, xs_s,
                                                              sa_s, pf);
    }
    grid.sync();
  }
  bool sand_last = false;
  if constexpr (GEMMA) sand_last = a.pm_norm != nullptr;
  if (sand_last) {  // the last layer's post-MLP sandwich norm, y = x
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
          bool ARCH, bool GEMMA = false, bool TCK = false>
cudaError_t launch_grouped(const W8A8Args& a, cudaStream_t s) {
  if (!GEMMA && gemma_any(&a)) return cudaErrorInvalidValue;
  auto kernel = grouped_megastep_kernel<TB, BITS, KMAJ, OPT, LM, LORA, ARCH,
                                        GEMMA, TCK>;
  if (a.Tb > kAttnKeys || a.T % a.Tb || !a.att_part || !a.att_flag ||
      !a.att_count)
    return cudaErrorInvalidValue;
  size_t kmax = (size_t)a.H;
  if (!KMAJ) kmax = (size_t)std::max(a.H, std::max(a.q_dim, a.ti));
  size_t work = kSaBytes + TB * ((kmax + 127) / 128) * kPad;
  if (KMAJ && kSaBytes + (size_t)TB * a.gs > work)
    work = kSaBytes + (size_t)TB * a.gs;
  const size_t head =
      kHeadBytes + kWarps * pf_floats<TB, BITS>() * sizeof(float);
  // the attention phase takes the whole of it
  const size_t smem = std::max(head + work, kGAttnBytes);
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
  } else if constexpr ((BITS == 4 || BITS == 8) && !KMAJ) {
    // batches of token groups: the kernel with the tensor-core tiles
    if (a.B > kGroupTB)
      return launch_grouped<kGroupTB, BITS, KMAJ, OPT, LM, LORA, ARCH, GEMMA,
                            true>(a, s);
    if (a.B <= 1)
      return launch_grouped<1, BITS, KMAJ, OPT, LM, LORA, ARCH, GEMMA>(a, s);
    if (a.B <= 2)
      return launch_grouped<2, BITS, KMAJ, OPT, LM, LORA, ARCH, GEMMA>(a, s);
    if (a.B <= 4)
      return launch_grouped<4, BITS, KMAJ, OPT, LM, LORA, ARCH, GEMMA>(a, s);
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
