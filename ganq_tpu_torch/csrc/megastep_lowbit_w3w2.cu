// Whole decode step over all layers in one launch, uniform 3- and 2-bit
// weights (kernel 14, variants "w3" and "w2"), for Hopper (sm_90a).
//
// Replaces ganq_tpu/ops/megastep_lowbit.py megastep_lowbit_decode (Pallas
// _megastep_lb_kernel) at bits 3 and 2, batch <= 64, for packs without
// optional operands (with any of them: megastep_lowbit_w3w2_ext.cu). The
// kernel is megastep_grouped.cuh's with kernel 14's 3- and 2-bit planes
// (megapack_lowbit, ``_PLAN``): a lane reads the NP plane bytes of a packed
// unit (3 at 3 bits, 1 at 2) and recovers the codes of its g_r row blocks
// (8 and 4) by shift and mask, the top field of each plane stored XOR its
// sign bit and the split rows of the 3-bit plan joined as hi << shift | lo
// (plane_fields); the exact int32 group dot is the codes' dp4a dot less
// 2^(bits-1) times the group's activation sum, then s_g z summed over the
// groups in order, as at 4 and 8 bits. A warp's values (packed rows x row
// blocks x token rows) fit its 32 lanes with token groups of 2 rows at 3
// bits and 4 at 2 (max_tb). Bound: the code bytes, L (Dqkv + Dq + 3 I) H
// bits / 8 (1.06 GB at Llama-3.2-3B for 3 bits, 0.70 GB for 2), plus their
// bf16 scales and the K/V history, over 3.35 TB/s.

#include "megastep_grouped.cuh"

// megastep_lowbit.cu's operands at bits 3 or 2 (qkv_pk [L, NP Dqkv / g_r,
// H], o_pk and dn_pk [L, NP H / g_r, q_dim or I], gu_pk [L, 2 NP I / g_r,
// H], tile-major planes) and none of the optional ones. Returns the
// cooperative launch's cudaError_t.
extern "C" int ganq_megastep_lowbit_w3w2(const W8A8Args* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->kmajor || p->B > 64 || p->qkv_sz || p->ap_q || p->lm_w8 ||
      lora_any(p) || arch_any(p) || gemma_any(p))
    return (int)cudaErrorInvalidValue;
  if (p->bits == 3) return (int)launch_grouped_b<3, false, false>(*p, s);
  if (p->bits == 2) return (int)launch_grouped_b<2, false, false>(*p, s);
  return (int)cudaErrorInvalidValue;
}
