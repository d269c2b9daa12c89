// Whole decode step over all layers in one launch, per-row 8-entry 3-bit
// codebooks through the Walsh planes (kernel 14, variant "wl8"), for
// Hopper (sm_90a).
//
// Replaces ganq_tpu/ops/megastep_lowbit.py megastep_lowbit_decode (Pallas
// _megastep_lb_kernel with walsh=7: the 3 stored bit planes of
// megapack_walsh, the 4 interaction planes XOR-derived, the Walsh
// coefficient rows in the scales' slots) at batch <= 64, with the qk-norm
// rows, the o/gate-up/down biases, the EoRA epilogue, the trailing-unembed
// fold and gemma's sandwich norms, windows, softcap and dual rope as
// runtime flags (lut artifacts carry no zero points or act-order). The TPU
// kernel forms the monomial dots as masked-prefix MXU products; here the
// qkv, o, gate/up and down phases are megastep_grouped.cuh's Walsh walks
// (wphase_*): a block per two packed units (16 output rows) and 8 token
// rows, its warps splitting the columns, the 7 monomial dots and the
// activation sums as int8 tensor-core products (mma.sync m16n8k32, exact
// int32, the warps' partial sums added in shared memory), then the float32
// recomposition c0 S + c1 z1 + ... + c7 z7 in the TPU kernel's order.
// Bound: the 3 bit planes, L (Dqkv + Dq + 3 I) H 3 / 8 bytes (1.06 GB at
// Llama-3.2-3B), plus the float32 coefficient rows (8 per output row, 25 MB)
// and the K/V history, over 3.35 TB/s.

#include "megastep_grouped.cuh"

// megapack_walsh's operands in W8A8Args: bits 3; qkv_pk [L, 3 Dqkv / 8, H],
// o_pk [L, 3 H / 8, q_dim], gu_pk [L, 6 I / 8, H] (gate tiles, then up
// tiles), dn_pk [L, 3 H / 8, I]; the coefficient rows float32 in the
// scales' fields, qkv_gs [L, 8, Dqkv], o_gs [L, 8, H], gu_gs [L, 8, 2 I]
// tile-major, dn_gs [L, 8, H]; the norms, caches, positions, rope tables
// and scratch as megastep_lowbit.cu's; any of the optional operands of
// megastep_lowbit_gemma.cu except zero points and act-order. Returns the
// cooperative launch's cudaError_t.
extern "C" int ganq_megastep_lowbit_walsh(const W8A8Args* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->bits != 3 || !gemma_ok(p) || p->qkv_sz || p->o_sz || p->gu_sz ||
      p->dn_sz || p->ap_q || p->ap_g || p->ap_o ||
      (lora_any(p) && !lora_all(p)) || (p->lm_w8 && !lm_operands_ok(p)) ||
      p->H % 128 || p->q_dim % 128 || p->ti % 128)
    return (int)cudaErrorInvalidValue;
  return (int)launch_grouped_b<kWalsh, false, false, true, true, true, true>(
      *p, s);
}
