// Whole decode step over all layers in one launch, symmetric W4A8 with
// pair-nibble bytes (kernel 13), for Hopper (sm_90a).
//
// Replaces ganq_tpu/ops/megastep4.py megastep4_decode (Pallas
// _megastep4_kernel), batch <= 8. The kernel is megastep_grouped.cuh's with
// kernel 13's layouts: qkv and gate/up bytes hold rows (i, i + tile / 2) of
// each row tile with the tile's first half in the low nibble; o and down
// are K-major and pair columns (c, c + H / 2), so their products are
// written as float32 group partials and summed in group order by an
// elementwise pass over the grid, whose last unit of a row forms the row's
// norm; rope reads its partner lane rounded to bf16. Bound: the
// 4-bit weight bytes and bf16 scales of all layers plus the K/V history
// over 3.35 TB/s (0.43 ms a step at Llama-3.2-3B and short contexts).

#include "megastep_grouped.cuh"

// ganq_tpu_torch/ops/megastep4.py megapack4's operands in W8A8Args: x and y
// [B, H] float32 (B <= 8); attn_norm/mlp_norm [L, H]; qkv_pk = qkv_p4
// [L, Dqkv / 2, H], qkv_gs [L, G, Dqkv], qkv_bias [L, Dqkv]; o_pk = o_p4
// [L, q_dim, H / 2], o_gs [L, Gq, H]; gu_pk = gu_p4 [L, I, H], gu_gs
// [L, G, 2 I] tile-major; dn_pk = dn_p4 [L, I, H / 2], dn_gs
// [L, NG * gtp, H]; k/v_cache [L, B Hkv, T, 128] bf16; pos [B] int32;
// cos/sin_half [B, cos_ld]. Out kn/vn [L, B, kv_dim] bf16. Scratch:
// qkv_out [B, Dqkv] bf16, x8 [B, H], sx [B], xs [B, H], act_a [B, I], amax
// [B, I / ti], a8 [B, max(q_dim, I)], attn [B, q_dim], attn_amax [B Hkv],
// partf [max(q_dim, I) / gs, B, H], and the attention items' att_part,
// att_flag and att_count (the last two zero between calls, see W8A8Args).
// Returns the cooperative launch's cudaError_t.
extern "C" int ganq_megastep4(const W8A8Args* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->bits != 4 || !p->kmajor || p->B > 8 || lora_any(p) ||
      arch_any(p))
    return (int)cudaErrorInvalidValue;
  return (int)launch_grouped_b<4, true, false>(*p, s);
}
