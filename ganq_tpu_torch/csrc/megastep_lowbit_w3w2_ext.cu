// Kernel 14's "w3" and "w2" variants (megastep_lowbit_w3w2.cu) with every
// optional operand as a runtime flag, for Hopper (sm_90a): zero points and
// act-order column orders, the trailing-unembed fold, the EoRA epilogue,
// qwen3-style qk-norm rows and the o/gate-up/down biases, and gemma's
// sandwich norms, windows, softcap and dual rope, each run where the call
// sets it (the GEMMA instantiation of megastep_grouped.cuh's kernel at 3
// and 2 bits: one source instead of one per combination).
//
// Replaces ganq_tpu/ops/megastep_lowbit.py megastep_lowbit_decode (Pallas
// _megastep_lb_kernel with its with_zp, with_aperm, NV, with_lora,
// with_qkn, with_bias, with_sand, with_win, softcap and rope_sel operands)
// at bits 3 and 2, batch <= 64. Bound: as megastep_lowbit_w3w2.cu's, plus
// the operands' bytes (float32 corrections, int32 orders, the int8 lm_head,
// bf16 adapter factors, float32 norms and biases).

#include "megastep_grouped.cuh"

// megastep_lowbit_w3w2.cu's operands with any of the optional operands of
// kernel 14 (megastep_lowbit_gemma.cu's list). Returns the cooperative
// launch's cudaError_t.
extern "C" int ganq_megastep_lowbit_w3w2_ext(const W8A8Args* p,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!gemma_ok(p) || (lora_any(p) && !lora_all(p)) ||
      (p->lm_w8 && !lm_operands_ok(p)) ||
      (p->qkv_sz != nullptr) != (p->dn_sz != nullptr) ||
      (p->ap_q != nullptr) != (p->ap_o != nullptr))
    return (int)cudaErrorInvalidValue;
  if (p->bits == 3)
    return (int)launch_grouped_b<3, false, true, true, true, true, true>(*p,
                                                                         s);
  if (p->bits == 2)
    return (int)launch_grouped_b<2, false, true, true, true, true, true>(*p,
                                                                         s);
  return (int)cudaErrorInvalidValue;
}
