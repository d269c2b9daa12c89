// Kernel 14 with qwen3's per-head qk-norm and the o/gate-up/down biases (the
// ARCH instantiations of megastep_grouped.cuh's kernel), with the EoRA
// epilogue (megastep_lowbit_lora*.cu), zero points or act-order
// (megastep_lowbit_opt.cu), for Hopper (sm_90a), in a source of its own so
// that the kernel-14 sources compile in parallel and the kernels without
// these operands keep their code.
//
// Replaces ganq_tpu/ops/megastep_lowbit.py megastep_lowbit_decode (Pallas
// _megastep_lb_kernel with its with_qkn and with_bias operands and the EoRA
// epilogue, zero points or act-order) at bits 4 and 8, batch <= 64. Bound:
// the step's weight bytes, as megastep_lowbit.cu's, plus the qk-norm rows (2
// Dqkv floats a layer) and the biases ((2 H + 2 I) floats a layer), under
// 0.2% of a W4 layer's.

#include "megastep_grouped.cuh"

// megastep_lowbit.cu's operands with qk_nm [L, 2, Dqkv] and qkv_f [B, Dqkv]
// float32, or o_bias [L, H], gu_bias [L, 2 I] and dn_bias [L, H] float32,
// or both. Returns the cooperative launch's cudaError_t.
extern "C" int ganq_megastep_lowbit_arch_lora_opt(const W8A8Args* p,
                                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!arch_ok(p) || !lora_all(p) || p->lm_w8 || !(p->qkv_sz || p->ap_q))
    return (int)cudaErrorInvalidValue;
  if (p->bits == 4)
    return (int)launch_grouped_b<4, false, true, false, true, true>(*p, s);
  if (p->bits == 8)
    return (int)launch_grouped_b<8, false, true, false, true, true>(*p, s);
  return (int)cudaErrorInvalidValue;
}
