// Whole decode step over all layers in one launch, plane-packed uniform
// weights (kernel 14, variants "w4p" and "w8p"), for Hopper (sm_90a).
//
// Replaces ganq_tpu/ops/megastep_lowbit.py megastep_lowbit_decode (Pallas
// _megastep_lb_kernel) at bits 4 and 8, batch <= 64, for packs without
// optional operands (with zero points or act-order: megastep_lowbit_opt.cu).
// The kernel is megastep_grouped.cuh's with kernel 14's layouts:
// every projection row-major, 8-bit planes one code a byte (stored XOR
// 128, so the signed byte is the centred code), 4-bit planes two rows a
// byte with the row tile's first half in the high nibble; rope reads its
// partner lane in float32 (the TPU kernel's lane rolls). Bound: the weight
// bytes and bf16 scales of all layers plus the K/V history over 3.35 TB/s
// (0.43 ms a step for w4p and 0.86 for w8p at Llama-3.2-3B and short
// contexts).

#include "megastep_grouped.cuh"

// ganq_tpu_torch/ops/megastep_lowbit.py megapack_lowbit's operands in
// W8A8Args, F = 8 / bits rows a byte: x and y [B, H] float32 (B <= 64);
// attn_norm/mlp_norm [L, H]; qkv_pk [L, Dqkv / F, H], qkv_gs [L, G, Dqkv],
// qkv_bias [L, Dqkv]; o_pk [L, H / F, q_dim], o_gs [L, Gq, H]; gu_pk
// [L, 2 I / F, H], gu_gs [L, G, 2 I] tile-major; dn_pk [L, H / F, I], dn_gs
// [L, NG * gtp, H]; k/v_cache [L, B Hkv, T, 128] bf16; pos [B] int32;
// cos/sin_half [B, cos_ld]. Out kn/vn [L, B, kv_dim] bf16. Scratch:
// qkv_out [B, Dqkv] bf16, x8 [B, H], sx [B], xs [B, H], act_a [B, I], amax
// [B, I / ti], a8 [B, max(q_dim, I)], attn [B, q_dim], attn_amax [B Hkv].
// Packs with zero points or act-order take ganq_megastep_lowbit_opt
// (megastep_lowbit_opt.cu).
// Returns the cooperative launch's cudaError_t.
extern "C" int ganq_megastep_lowbit(const W8A8Args* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->kmajor || p->B > 64 || p->qkv_sz || p->ap_q)
    return (int)cudaErrorInvalidValue;
  if (p->bits == 4) return (int)launch_grouped_b<4, false, false>(*p, s);
  if (p->bits == 8) return (int)launch_grouped_b<8, false, false>(*p, s);
  return (int)cudaErrorInvalidValue;
}
