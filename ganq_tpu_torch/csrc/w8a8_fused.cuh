// Phases of the fused W8A8 decode kernels for Hopper (sm_90a), shared by
// w8a8_fused.cu (kernels 9-11: a short fixed sequence of ordinary launches,
// one phase each) and megastep_w8.cu (kernel 12: one cooperative launch
// that runs every phase of every layer, with a grid barrier between them).
//
// Every phase walks its work units grid-stride (blockIdx.x, gridDim.x), so
// one function serves both. Blocks have kThreads threads; token rows come in
// groups of TB <= 8 (the int8 activations of a group are staged in shared
// memory and reused by every weight row).
//
// Numerics are the TPU kernels' (ganq_tpu/ops/fused_mlp.py, fused_attention.py,
// fused_layer.py, megastep.py), in the same order, so that the plain PyTorch
// versions (ganq_tpu_torch/ops/*) reproduce them:
// * int8 activations: a8_quant.cuh's rule (sx = max|x| * fl(1/127), the
//   codes an IEEE quotient with ties to even);
// * int8 products: exact int32 sums (dp4a), then ((float)acc * sx) * s;
// * rope: y * cos + (bf16(y_partner) * sign) * sin, no fused multiply-add;
// * MLP: per-tile activation scales; the down product of each tile is an
//   exact int32 sum, and the float sum over tiles runs in tile order;
// * attention: flash over key blocks of Tb with a running max per block,
//   p rounded to bf16 before p . v, l summed from the unrounded p, masked
//   scores -1e30, keys at or past pos never read, the current token folded
//   in last; the output's int8 scale is max(1e-12, max|a| over all heads)
//   * fl(1/127) per batch row (sa_of, a8_quant.cuh).
// Reductions across blocks that must be exact are int32 atomics (sums) or
// integer max on float bits (non-negative maxima), so results do not depend
// on the order blocks run in.

#pragma once

#include "a8_quant.cuh"

// The argument block (ganq_tpu_torch/ops/w8a8_args.py W8A8Args, same
// order). Weights of kernel 12 carry a leading layer axis; strides are in
// elements.
struct W8A8Args {
  int B, H, Kx, q_dim, kv_dim, d, rd, interleaved, qkv_ld, o_rows, I, ti,
      down_ld, T, Tb, L, fold_norm, act, x_bf16;
  // kernels 13 and 14 (megastep_grouped.cuh): group size, code bits, qkv
  // row tile, padded scale rows per MLP tile, rope-table row stride, and
  // kernel 13's layouts (low nibble first, K-major o and down)
  int gs, bits, tq, gtp, cos_ld, kmajor;
  float eps, rms_offset, scale;
  long long cache_sb, cache_sg, cache_st, cache_sl;
  const void* x;
  const float* attn_norm;
  const float* mlp_norm;
  const int8_t* qkv_w8;
  const float* qkv_scale;
  const float* qkv_bias;
  const float* cos_half;
  const float* sin_half;
  const __nv_bfloat16* k_cache;
  const __nv_bfloat16* v_cache;
  const int* pos;
  const int8_t* o_t_w8;
  const float* o_t_scale;
  const int8_t* gateup_w8;
  const float* gateup_scale;
  const int8_t* down_w8;
  const float* down_scale;
  void* y;
  __nv_bfloat16* qkv_out;
  __nv_bfloat16* kn;
  __nv_bfloat16* vn;
  int8_t* x8;
  float* sx;
  float* xs;
  float* act_a;
  int* amax;
  int8_t* a8;
  float* attn;
  float* attn_amax;
  int* o32;
  int* part;
  // kernels 13 and 14: packed codes, bf16 group scales [L, groups, rows]
  // (kernel 14's Walsh planes: float32 coefficient rows [L, 8, rows]),
  // float32 group partials of kernel 13's K-major products
  const int8_t* qkv_pk;
  const int8_t* o_pk;
  const int8_t* gu_pk;
  const int8_t* dn_pk;
  const __nv_bfloat16* qkv_gs;
  const __nv_bfloat16* o_gs;
  const __nv_bfloat16* gu_gs;
  const __nv_bfloat16* dn_gs;
  float* partf;
  // kernel 14: float32 zero-point corrections scale * (2^(bits-1) - zero)
  // in the scales' layouts, and act-order column orders of the qkv and
  // gate/up activations [L, H] and of the attention output [L, q_dim]
  // (each null when the pack has none)
  const float* qkv_sz;
  const float* o_sz;
  const float* gu_sz;
  const float* dn_sz;
  const int* ap_q;
  const int* ap_g;
  const int* ap_o;
  // kernel 14's trailing-unembed fold (lm_w8 null: no fold): the int8
  // lm_head rows [V, H], their float32 scales [V], the final norm's
  // float32 weight [H], and the logits out [B, V] float32
  const int8_t* lm_w8;
  const float* lm_scale;
  const float* lm_norm;
  float* logits;
  int V;
  // kernel 14's EoRA epilogue (la_q null: none): the bf16 factors A [L, r,
  // K] and B [L, N, r] of q (K = H, N = Dqkv), o (q_dim, H), gate/up (H,
  // 2 I, rows tile-major like gu_gs) and down (I, H), in the pack's column
  // orders; float32 scratch x @ A^T [B, r] of each; the four ranks
  const __nv_bfloat16* la_q;
  const __nv_bfloat16* lb_q;
  const __nv_bfloat16* la_o;
  const __nv_bfloat16* lb_o;
  const __nv_bfloat16* la_g;
  const __nv_bfloat16* lb_g;
  const __nv_bfloat16* la_d;
  const __nv_bfloat16* lb_d;
  float* xa_q;
  float* xa_o;
  float* xa_g;
  float* xa_d;
  int r_q, r_o, r_g, r_d;
  // kernel 14's architecture operands (the ARCH instantiations; each null
  // where the pack has none), float32: qwen3's qk-norm rows [L, 2, Dqkv]
  // (the lane-expanded norm weight over the apply mask), the o, gate/up
  // and down biases [L, H], [L, 2 I] (tile-major like gu_gs) and [L, H],
  // and with qk_nm the scratch [B, Dqkv] of the pre-rope qkv rows
  const float* qk_nm;
  const float* o_bias;
  const float* gu_bias;
  const float* dn_bias;
  float* qkv_f;
  // kernel 14's gemma operands (the GEMMA instantiation; each null, and
  // softcap 0, where the call has none): the sandwich norms' float32
  // weights [L, H] with the float32 scratch [B, H] of the o and down
  // outputs they norm, each layer's sliding window [L] (T on a full layer),
  // the per-layer rope-table selector [L] (1: the second of two tables
  // [2, B, cos_ld]), and the attention softcap
  const float* pa_norm;
  const float* pm_norm;
  const int* windows;
  const int* rope_sel;
  float* sand;
  float softcap;
  // kernels 13 and 14 (megastep_grouped.cuh): float32 partials [B Hkv,
  // T / Tb, qpk (d + 2)] of each attention flash block (p . v, the sum of
  // p, the block max), int32 flags [B Hkv, T / Tb] of the blocks' maxima,
  // and int32 arrival counters of the attention units [B Hkv] and the
  // token rows [B], zero between calls (the kernel sets each back)
  float* att_part;
  int* att_flag;
  int* att_count;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQpk = 8;        // query heads per kv head (attention smem)
constexpr int kMaxTb = 256;       // keys per flash block
constexpr int kKChunk = 64;       // rows per K-major unit
constexpr int kNCols = 4 * kThreads;  // columns per K-major unit
constexpr int kDownChunk = 512;   // columns per staged chunk (N-major down)

__device__ __forceinline__ float bf16r(float v) { return rnd<bf16>(v); }

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) t += red[i];
  return t;
}

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) t = fmaxf(t, red[i]);
  return t;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// act(g) * u with PyTorch's formulas (silu as g / (1 + exp(-g)))
__device__ __forceinline__ float gated(float g, float u, int act) {
  float a;
  if (act == 0) {
    a = g / (1.f + expf(-g));
  } else if (act == 1) {
    const float inner = 0.7978845608028654f * (g + 0.044715f * g * g * g);
    a = 0.5f * g * (1.f + tanhf(inner));
  } else {
    a = g * 0.5f * (1.f + erff(g * 0.7071067811865476f));
  }
  return __fmul_rn(a, u);
}

// ---------------------------------------------------------------- rows
constexpr int kRowRegs = 16;   // row elements a thread holds (K <= 4096)

// One token row: h = x (or x * rsqrt(mean(x^2) + eps) * (w + offset) over
// the first H columns when w is given), int8 codes of h over K >= H columns
// (x holds zeros past H) and its scale. Block-level; red: kWarps floats.
// Rows of up to kRowRegs * kThreads columns are read once into registers.
template <typename T>
__device__ void row_norm_quant(const T* __restrict__ xr, int H, int K,
                               const float* __restrict__ w, float eps,
                               float off, int8_t* __restrict__ x8r,
                               float* __restrict__ sx, float* red) {
  if (K <= kRowRegs * kThreads) {
    float h[kRowRegs];
#pragma unroll
    for (int i = 0; i < kRowRegs; ++i) {
      const int k = threadIdx.x + i * kThreads;
      h[i] = k < K ? to_f(xr[k]) : 0.f;
    }
    if (w) {
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < kRowRegs; ++i) ss += h[i] * h[i];
      const float r = rsqrtf(block_sum(ss, red) / (float)H + eps);
#pragma unroll
      for (int i = 0; i < kRowRegs; ++i) {
        const int k = threadIdx.x + i * kThreads;
        h[i] = k < H ? __fmul_rn(__fmul_rn(h[i], r), w[k] + off) : 0.f;
      }
    }
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < kRowRegs; ++i) amax = fmaxf(amax, fabsf(h[i]));
    const float s = sx_of(block_max(amax, red));
#pragma unroll
    for (int i = 0; i < kRowRegs; ++i) {
      const int k = threadIdx.x + i * kThreads;
      if (k < K) x8r[k] = (int8_t)quant8(h[i], s);
    }
    if (threadIdx.x == 0) *sx = s;
    return;
  }
  float r = 1.f;
  if (w) {
    float ss = 0.f;
#pragma unroll 4
    for (int k = threadIdx.x; k < H; k += kThreads) {
      const float v = to_f(xr[k]);
      ss += v * v;
    }
    const float var = block_sum(ss, red) / (float)H;
    r = rsqrtf(var + eps);
  }
  float amax = 0.f;
#pragma unroll 4
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const float v = to_f(xr[k]);
    const float h = w ? (k < H ? __fmul_rn(__fmul_rn(v, r), w[k] + off) : 0.f)
                      : v;
    amax = fmaxf(amax, fabsf(h));
  }
  amax = block_max(amax, red);
  const float s = sx_of(amax);
#pragma unroll 4
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const float v = to_f(xr[k]);
    const float h = w ? (k < H ? __fmul_rn(__fmul_rn(v, r), w[k] + off) : 0.f)
                      : v;
    x8r[k] = (int8_t)quant8(h, s);
  }
  if (threadIdx.x == 0) *sx = s;
}

// ------------------------------------------------------------ staging
// x8 rows b0 .. b0 + nb of width K (K % 16 == 0) into xs [TB][K]; rows past
// nb are zeros. Block-level, ends with a barrier.
template <int TB>
__device__ void stage_rows(const int8_t* __restrict__ x8, int b0, int nb,
                           int K, int8_t* xs) {
  const int n16 = K / 16;
  for (int e = threadIdx.x; e < TB * n16; e += kThreads) {
    const int b = e / n16, c = e - b * n16;
    int4 v = make_int4(0, 0, 0, 0);
    if (b < nb) v = *reinterpret_cast<const int4*>(x8 + (size_t)(b0 + b) * K + 16 * c);
    reinterpret_cast<int4*>(xs + (size_t)b * K)[c] = v;
  }
  __syncthreads();
}

// acc[r][b] = sum_k row_r[k] * xs[b][k] over K columns (K % 16 == 0, rows
// 16-byte aligned), reduced across the warp (every lane holds the sums).
template <int TB>
__device__ __forceinline__ void warp_dot2(const int8_t* __restrict__ r0,
                                          const int8_t* __restrict__ r1,
                                          const int8_t* xs, int K,
                                          int (&acc)[2][TB]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 0; b < TB; ++b) acc[0][b] = acc[1][b] = 0;
#pragma unroll 3
  for (int k = 16 * lane; k < K; k += 512) {
    const int4 w0 = __ldg(reinterpret_cast<const int4*>(r0 + k));
    const int4 w1 = __ldg(reinterpret_cast<const int4*>(r1 + k));
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const int4 xv = *reinterpret_cast<const int4*>(xs + (size_t)b * K + k);
      int a0 = acc[0][b], a1 = acc[1][b];
      a0 = __dp4a(w0.x, xv.x, a0); a0 = __dp4a(w0.y, xv.y, a0);
      a0 = __dp4a(w0.z, xv.z, a0); a0 = __dp4a(w0.w, xv.w, a0);
      a1 = __dp4a(w1.x, xv.x, a1); a1 = __dp4a(w1.y, xv.y, a1);
      a1 = __dp4a(w1.z, xv.z, a1); a1 = __dp4a(w1.w, xv.w, a1);
      acc[0][b] = a0;
      acc[1][b] = a1;
    }
  }
#pragma unroll
  for (int b = 0; b < TB; ++b) {
    acc[0][b] = __reduce_add_sync(0xffffffffu, acc[0][b]);
    acc[1][b] = __reduce_add_sync(0xffffffffu, acc[1][b]);
  }
}

// --------------------------------------------------------- qkv + rope
// Row pair u of the fused qkv rows: a rope pair (partner lanes) or two
// neighbouring lanes that rope leaves as they are.
__device__ __forceinline__ void qkv_pair(int u, int d, int rd, int inter,
                                         int n_rope, int& r0, int& r1,
                                         int& ci, bool& rope) {
  const int hd = d >> 1, head = u / hd, k = u - head * hd, base = head * d;
  const int rh = rd >> 1;
  rope = base < n_rope && k < rh;
  ci = k;
  if (rope) {
    r0 = inter ? base + 2 * k : base + k;
    r1 = inter ? r0 + 1 : r0 + rh;
  } else if (base < n_rope) {
    r0 = base + rd + 2 * (k - rh);
    r1 = r0 + 1;
  } else {
    r0 = base + 2 * k;
    r1 = r0 + 1;
  }
}

// qkv [B, Dqkv] bf16 (and the k/v sections into kn/vn [B, kv_dim] when
// given) from x8 [B, K], sx [B]: one warp per row pair, TB token rows per
// group. Weights: w [Dqkv, ld] int8, s [Dqkv], bias [Dqkv] (or null).
template <int TB>
__device__ void phase_qkv(const W8A8Args& a, const int8_t* __restrict__ w,
                          const float* __restrict__ s,
                          const float* __restrict__ bias,
                          const int8_t* __restrict__ x8,
                          const float* __restrict__ sx, bf16* qkv, bf16* kn,
                          bf16* vn, int8_t* xs) {
  const int K = a.H, Dqkv = a.q_dim + 2 * a.kv_dim;
  const int n_rope = a.rd ? a.q_dim + a.kv_dim : 0;
  const int units = Dqkv / 2;
  const int nrb = (units + kWarps - 1) / kWarps;
  const int groups = (a.B + TB - 1) / TB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int staged = -1;
  for (int bu = blockIdx.x; bu < nrb * groups; bu += gridDim.x) {
    const int grp = bu / nrb, u = (bu - grp * nrb) * kWarps + warp;
    const int b0 = grp * TB, nb = min(TB, a.B - b0);
    if (grp != staged) {
      __syncthreads();
      stage_rows<TB>(x8, b0, nb, K, xs);
      staged = grp;
    }
    if (u >= units) continue;
    int r0, r1, ci;
    bool rope;
    qkv_pair(u, a.d, a.rd, a.interleaved, n_rope, r0, r1, ci, rope);
    int acc[2][TB];
    warp_dot2<TB>(w + (size_t)r0 * a.qkv_ld, w + (size_t)r1 * a.qkv_ld, xs, K,
                  acc);
    if (lane >= nb) continue;
    // lane b writes token row b0 + b
    int a0 = 0, a1 = 0;
#pragma unroll
    for (int b = 0; b < TB; ++b)
      if (b == lane) { a0 = acc[0][b]; a1 = acc[1][b]; }
    const int b = b0 + lane;
    float y0 = __fmul_rn(__fmul_rn((float)a0, sx[b]), s[r0]);
    float y1 = __fmul_rn(__fmul_rn((float)a1, sx[b]), s[r1]);
    if (bias) {
      y0 = __fadd_rn(y0, bias[r0]);
      y1 = __fadd_rn(y1, bias[r1]);
    }
    if (rope) {
      const float c = a.cos_half[ci], sn = a.sin_half[ci];
      const float o0 = __fadd_rn(__fmul_rn(y0, c), __fmul_rn(-bf16r(y1), sn));
      const float o1 = __fadd_rn(__fmul_rn(y1, c), __fmul_rn(bf16r(y0), sn));
      y0 = o0;
      y1 = o1;
    }
    const int rr[2] = {r0, r1};
    const float yy[2] = {y0, y1};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const bf16 v = __float2bfloat16(yy[i]);
      const int r = rr[i];
      qkv[(size_t)b * Dqkv + r] = v;
      if (kn && r >= a.q_dim && r < a.q_dim + a.kv_dim)
        kn[(size_t)b * a.kv_dim + r - a.q_dim] = v;
      if (vn && r >= a.q_dim + a.kv_dim)
        vn[(size_t)b * a.kv_dim + r - a.q_dim - a.kv_dim] = v;
    }
  }
}

// ------------------------------------------------------------ gate/up
// a = act((g32 * sx) * gs) * ((u32 * sx) * us) for the I rows of gate (w
// rows m) and up (rows I + m), into act [B, I] f32, with the per-row,
// per-tile max|a| as float bits in amax [B, I / ti] (atomic integer max).
template <int TB>
__device__ void phase_gateup(const W8A8Args& a, const int8_t* __restrict__ w,
                             const float* __restrict__ s,
                             const int8_t* __restrict__ x8,
                             const float* __restrict__ sx, float* act,
                             int* amax, int8_t* xs) {
  const int K = a.Kx, I = a.I, ng = I / a.ti;
  const int nrb = (I + kWarps - 1) / kWarps;
  const int groups = (a.B + TB - 1) / TB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int staged = -1;
  for (int bu = blockIdx.x; bu < nrb * groups; bu += gridDim.x) {
    const int grp = bu / nrb, m = (bu - grp * nrb) * kWarps + warp;
    const int b0 = grp * TB, nb = min(TB, a.B - b0);
    if (grp != staged) {
      __syncthreads();
      stage_rows<TB>(x8, b0, nb, K, xs);
      staged = grp;
    }
    if (m >= I) continue;
    int acc[2][TB];
    warp_dot2<TB>(w + (size_t)m * K, w + (size_t)(I + m) * K, xs, K, acc);
    if (lane >= nb) continue;
    int a0 = 0, a1 = 0;
#pragma unroll
    for (int b = 0; b < TB; ++b)
      if (b == lane) { a0 = acc[0][b]; a1 = acc[1][b]; }
    const int b = b0 + lane;
    const float g = __fmul_rn(__fmul_rn((float)a0, sx[b]), s[m]);
    const float u = __fmul_rn(__fmul_rn((float)a1, sx[b]), s[I + m]);
    const float v = gated(g, u, a.act);
    act[(size_t)b * I + m] = v;
    atomicMax(amax + (size_t)b * ng + m / a.ti, __float_as_int(fabsf(v)));
  }
}

__device__ __forceinline__ float tile_scale(const int* amax, int b, int ng,
                                            int t) {
  return sx_of(__int_as_float(amax[(size_t)b * ng + t]));
}

// ----------------------------------------------------- K-major product
// acc[c][b] += sum over rows k0 .. k0 + 63 of w[k][n + c] * a8[b][k] for the
// 4 columns n .. n + 3 of this thread; a8w: TB x 16 words of packed codes.
template <int TB>
__device__ __forceinline__ void kmajor_dot(const int8_t* __restrict__ w,
                                           int ld, int k0, int n,
                                           const int* a8w, int (&acc)[4][TB]) {
#pragma unroll 4
  for (int kk = 0; kk < kKChunk; kk += 4) {
    const int8_t* p = w + (size_t)(k0 + kk) * ld + n;
    const unsigned w0 = __ldg(reinterpret_cast<const unsigned*>(p));
    const unsigned w1 = __ldg(reinterpret_cast<const unsigned*>(p + ld));
    const unsigned w2 = __ldg(reinterpret_cast<const unsigned*>(p + 2 * ld));
    const unsigned w3 = __ldg(reinterpret_cast<const unsigned*>(p + 3 * ld));
    // column c of the 4 x 4 bytes: rows kk .. kk + 3 in byte order
    const unsigned t0 = __byte_perm(w0, w1, 0x5140);
    const unsigned t1 = __byte_perm(w0, w1, 0x7362);
    const unsigned t2 = __byte_perm(w2, w3, 0x5140);
    const unsigned t3 = __byte_perm(w2, w3, 0x7362);
    const int c0 = (int)__byte_perm(t0, t2, 0x5410);
    const int c1 = (int)__byte_perm(t0, t2, 0x7632);
    const int c2 = (int)__byte_perm(t1, t3, 0x5410);
    const int c3 = (int)__byte_perm(t1, t3, 0x7632);
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const int av = a8w[b * 16 + kk / 4];
      acc[0][b] = __dp4a(c0, av, acc[0][b]);
      acc[1][b] = __dp4a(c1, av, acc[1][b]);
      acc[2][b] = __dp4a(c2, av, acc[2][b]);
      acc[3][b] = __dp4a(c3, av, acc[3][b]);
    }
  }
}

// packs int8 codes of src[b][k0 .. k0 + 63] (f32, row stride ld) with the
// per-row scale sc[b] into a8w [TB][16] words; rows past B are zeros.
// Block-level, ends with a barrier.
template <int TB>
__device__ void stage_kchunk(const float* __restrict__ src, int ld, int B,
                             int k0, const float* sc, int* a8w) {
  for (int e = threadIdx.x; e < TB * 16; e += kThreads) {
    const int b = e / 16, wd = e - b * 16;
    unsigned v = 0;
    if (b < B) {
      const float* p = src + (size_t)b * ld + k0 + 4 * wd;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v |= ((unsigned)(uint8_t)(int8_t)quant8(p[i], sc[b])) << (8 * i);
    }
    a8w[e] = (int)v;
  }
  __syncthreads();
}

// o32 [B, H] += a8 . o_t over the first q_dim rows of o_t [rows, H] (int32
// atomics), a8 from attn [B, q_dim] with sa = max(1e-12, max|a|) * fl(1/127)
// per batch row (from the per-kv-head maxima attn_amax [B, Hkv]).
template <int TB>
__device__ void phase_oproj(const W8A8Args& a, const int8_t* __restrict__ ot,
                            const float* attn, const float* attn_amax,
                            int* o32, int* a8w, float* sa) {
  const int Hkv = a.kv_dim / a.d;
  if (threadIdx.x < TB) {
    float m = 1e-12f;
    if ((int)threadIdx.x < a.B)
      for (int g = 0; g < Hkv; ++g)
        m = fmaxf(m, attn_amax[threadIdx.x * Hkv + g]);
    sa[threadIdx.x] = sa_of(m);
  }
  __syncthreads();
  const int nk = a.q_dim / kKChunk, nn = (a.H + kNCols - 1) / kNCols;
  for (int un = blockIdx.x; un < nk * nn; un += gridDim.x) {
    const int kc = un / nn, k0 = kc * kKChunk;
    const int n = (un - kc * nn) * kNCols + 4 * threadIdx.x;
    __syncthreads();
    stage_kchunk<TB>(attn, a.q_dim, a.B, k0, sa, a8w);
    if (n >= a.H) continue;
    int acc[4][TB];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int b = 0; b < TB; ++b) acc[c][b] = 0;
    kmajor_dot<TB>(ot, a.H, k0, n, a8w, acc);
#pragma unroll
    for (int b = 0; b < TB; ++b)
      if (b < a.B)
#pragma unroll
        for (int c = 0; c < 4; ++c) atomicAdd(o32 + (size_t)b * a.H + n + c, acc[c][b]);
  }
}

// part [NG, B, H] += per tile t the int32 product a8_t . down_t over the
// tile's rows of the K-major down_t [I, H], a8_t from act [B, I] with the
// tile's scale (kernel 12).
template <int TB>
__device__ void phase_down_kmajor(const W8A8Args& a,
                                  const int8_t* __restrict__ dt,
                                  const float* act, const int* amax,
                                  int* part, int* a8w, float* sa) {
  const int ng = a.I / a.ti, nk = a.I / kKChunk;
  const int nn = (a.H + kNCols - 1) / kNCols;
  for (int un = blockIdx.x; un < nk * nn; un += gridDim.x) {
    const int kc = un / nn, k0 = kc * kKChunk, t = k0 / a.ti;
    const int n = (un - kc * nn) * kNCols + 4 * threadIdx.x;
    __syncthreads();
    if (threadIdx.x < TB)
      sa[threadIdx.x] = (int)threadIdx.x < a.B
                            ? tile_scale(amax, threadIdx.x, ng, t) : 1.f;
    __syncthreads();
    stage_kchunk<TB>(act, a.I, a.B, k0, sa, a8w);
    if (n >= a.H) continue;
    int acc[4][TB];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int b = 0; b < TB; ++b) acc[c][b] = 0;
    kmajor_dot<TB>(dt, a.H, k0, n, a8w, acc);
#pragma unroll
    for (int b = 0; b < TB; ++b)
      if (b < a.B)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          atomicAdd(part + ((size_t)t * a.B + b) * a.H + n + c, acc[c][b]);
  }
}

// ----------------------------------------------------------- attention
constexpr int kPvParts = 8;                        // key parts of p . v
constexpr size_t kAttnSmemFloats =
    (size_t)kMaxQpk * 128 + (size_t)kMaxQpk * kMaxTb +
    (size_t)(kPvParts - 1) * kMaxQpk * 128 + 4 * kMaxQpk + kWarps;

__device__ __forceinline__ void bf16x4(uint2 raw, float* f) {
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  f[0] = __low2float(lo);
  f[1] = __high2float(lo);
  f[2] = __low2float(hi);
  f[3] = __high2float(hi);
}

// gemma2's attention softcap on a scaled score: cap * tanh(s * (1 / cap))
// (the TPU kernel's _cap), inv = 1 / cap in float32
__device__ __forceinline__ float soft_cap(float s, float cap, float inv) {
  return __fmul_rn(cap, tanhf(__fmul_rn(s, inv)));
}

// Flash GQA attention of one (batch row b, kv head g) unit: qpk query heads
// of the bf16 qkv row against the cache keys below pos, the row's history
// length (key t of the unit at kc + t * st), and the current token,
// head_dim 128. Per key block: a thread per key for the scores, a warp per
// head for the max and the sum, a thread per 4 dims and eighth of the keys
// for p . v (the eighths summed in order). Writes a = acc / l into attn
// [B, q_dim] and max|a| into attn_amax [b * Hkv + g]. smem:
// kAttnSmemFloats floats. GEMMA (kernel 14's gemma instantiation): the key
// walk starts at t_lo (a sliding window's first key, pos - window + 1;
// no key before it is read) in the blocks of a walk from key 0, and with
// cap != 0 each scaled score, the current token's too, is softcapped
// before the running max.
template <bool GEMMA = false>
__device__ void attn_unit(const W8A8Args& a, int b, int g,
                          const bf16* __restrict__ qkv,
                          const bf16* __restrict__ kc,
                          const bf16* __restrict__ vc, float* attn,
                          float* attn_amax, float* smem, int pos,
                          int t_lo = 0, float cap = 0.f) {
  const int t_start = GEMMA ? t_lo : 0;
  const float inv_cap = GEMMA && cap != 0.f ? 1.f / cap : 0.f;
  const int d = 128, Hkv = a.kv_dim / d, qpk = a.q_dim / d / Hkv;
  const int Dqkv = a.q_dim + 2 * a.kv_dim, Tb = a.Tb;
  const long long st = a.cache_st;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* qs = smem;                           // [qpk][128]
  float* sc = qs + kMaxQpk * d;               // [qpk][Tb]
  float* pvq = sc + kMaxQpk * kMaxTb;         // [parts 1..7][qpk][128]
  float* ms = pvq + (kPvParts - 1) * kMaxQpk * d;   // [qpk] running max
  float* ls = ms + kMaxQpk;                   // [qpk] running sum
  float* al = ls + kMaxQpk;                   // [qpk] this block's rescale
  float* pc = al + kMaxQpk;                   // [qpk] the current token's p
  float* red = pc + kMaxQpk;                  // [kWarps]
  const bf16* row = qkv + (size_t)b * Dqkv;
  for (int e = tid; e < qpk * d; e += kThreads)
    qs[e] = __bfloat162float(row[g * qpk * d + e]);
  if (tid < qpk) {
    ms[tid] = -1e30f;
    ls[tid] = 0.f;
  }
  const int dq = tid & 31, part = tid >> 5;   // dims 4 dq .. 4 dq + 3
  float acc[kMaxQpk][4];                      // (part 0)
#pragma unroll
  for (int h = 0; h < kMaxQpk; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[h][i] = 0.f;
  __syncthreads();

  // GEMMA: the first block runs from t_lo to the next multiple of Tb, so
  // that every later block, and each block's running max, is the one of a
  // walk from key 0 (the TPU kernel's blocks, its masked keys not read)
  for (int t0 = t_start; t0 < pos; t0 += GEMMA ? Tb - t0 % Tb : Tb) {
    const int nk = GEMMA ? min(Tb - t0 % Tb, pos - t0) : min(Tb, pos - t0);
    // scores: a thread per key
    for (int t = tid; t < nk; t += kThreads) {
      const bf16* kr = kc + (size_t)(t0 + t) * st;
      float s[kMaxQpk];
#pragma unroll
      for (int h = 0; h < kMaxQpk; ++h) s[h] = 0.f;
#pragma unroll 4
      for (int c = 0; c < d; c += 4) {
        float kv[4];
        bf16x4(*reinterpret_cast<const uint2*>(kr + c), kv);
#pragma unroll
        for (int h = 0; h < kMaxQpk; ++h)
          if (h < qpk) {
            const float* q = qs + h * d + c;
            s[h] = fmaf(q[0], kv[0], s[h]);
            s[h] = fmaf(q[1], kv[1], s[h]);
            s[h] = fmaf(q[2], kv[2], s[h]);
            s[h] = fmaf(q[3], kv[3], s[h]);
          }
      }
#pragma unroll
      for (int h = 0; h < kMaxQpk; ++h)
        if (h < qpk) {
          float v = s[h] * a.scale;
          if constexpr (GEMMA)
            if (cap != 0.f) v = soft_cap(v, cap, inv_cap);
          sc[h * Tb + t] = v;
        }
    }
    __syncthreads();
    // per head: block max, p = exp(s - m), their sum; a warp per head
    for (int h = warp; h < qpk; h += kWarps) {
      float mx = -1e30f;
      for (int t = lane; t < nk; t += 32) mx = fmaxf(mx, sc[h * Tb + t]);
      mx = warp_max(mx);
      const float m_new = fmaxf(ms[h], mx);
      float sum = 0.f;
      for (int t = lane; t < nk; t += 32) {
        const float p = expf(sc[h * Tb + t] - m_new);
        sc[h * Tb + t] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(ms[h] - m_new);
        al[h] = alpha;
        ls[h] = __fadd_rn(__fmul_rn(ls[h], alpha), sum);
        ms[h] = m_new;
      }
    }
    __syncthreads();
    // p . v with p rounded to bf16
    float pv[kMaxQpk][4];
#pragma unroll
    for (int h = 0; h < kMaxQpk; ++h)
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[h][i] = 0.f;
    const int per = (nk + kPvParts - 1) / kPvParts, lo = part * per;
    const int hi = min(nk, lo + per);
#pragma unroll 4
    for (int t = lo; t < hi; ++t) {
      float v[4];
      bf16x4(*reinterpret_cast<const uint2*>(vc + (size_t)(t0 + t) * st +
                                             4 * dq), v);
#pragma unroll
      for (int h = 0; h < kMaxQpk; ++h)
        if (h < qpk) {
          const float pr = bf16r(sc[h * Tb + t]);
#pragma unroll
          for (int i = 0; i < 4; ++i) pv[h][i] = fmaf(pr, v[i], pv[h][i]);
        }
    }
    if (part) {
#pragma unroll
      for (int h = 0; h < kMaxQpk; ++h)
        if (h < qpk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            pvq[((part - 1) * kMaxQpk + h) * d + 4 * dq + i] = pv[h][i];
    }
    __syncthreads();
    if (!part) {
#pragma unroll
      for (int h = 0; h < kMaxQpk; ++h)
        if (h < qpk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float sum = pv[h][i];
            for (int r = 0; r < kPvParts - 1; ++r)
              sum += pvq[(r * kMaxQpk + h) * d + 4 * dq + i];
            acc[h][i] = __fadd_rn(__fmul_rn(acc[h][i], al[h]), sum);
          }
    }
    __syncthreads();
  }

  // the current token (its k/v are this step's, in the qkv row), last
  const bf16* kcur = row + a.q_dim + g * d;
  const bf16* vcur = row + a.q_dim + a.kv_dim + g * d;
  for (int h = warp; h < qpk; h += kWarps) {
    const float* q = qs + h * d;
    float p = 0.f;
    for (int e = lane; e < d; e += 32)
      p = fmaf(q[e], __bfloat162float(kcur[e]), p);
    p = warp_sum(p) * a.scale;
    if constexpr (GEMMA)
      if (cap != 0.f) p = soft_cap(p, cap, inv_cap);
    if (lane == 0) {
      const float m_new = fmaxf(ms[h], p);
      const float alpha = expf(ms[h] - m_new);
      const float pe = expf(p - m_new);
      al[h] = alpha;
      ls[h] = __fadd_rn(__fmul_rn(ls[h], alpha), pe);
      ms[h] = m_new;
      pc[h] = pe;
    }
  }
  __syncthreads();
  float amax = 0.f;
  if (!part) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = __bfloat162float(vcur[4 * dq + i]);
#pragma unroll
      for (int h = 0; h < kMaxQpk; ++h) {
        if (h < qpk) {
          const float o = __fadd_rn(__fmul_rn(acc[h][i], al[h]),
                                    __fmul_rn(bf16r(pc[h]), v));
          const float out = o / fmaxf(ls[h], 1e-30f);
          attn[(size_t)b * a.q_dim + (g * qpk + h) * d + 4 * dq + i] = out;
          amax = fmaxf(amax, fabsf(out));
        }
      }
    }
  }
  amax = block_max(amax, red);
  if (tid == 0) attn_amax[b * Hkv + g] = amax;
  __syncthreads();
}

}  // namespace
