// Kernel 14 with zero points or act-order (megastep_lowbit_opt.cu) and the
// trailing-unembed fold (megastep_lowbit_lm.cu), for Hopper (sm_90a): the
// instantiations that read the float32 zero-point corrections and the
// act-order column orders and fold the lm_head in, in a source of their own
// so that the four sets of kernel-14 instantiations compile in parallel.
//
// Replaces ganq_tpu/ops/megastep_lowbit.py megastep_lowbit_decode (Pallas
// _megastep_lb_kernel with its with_zp / with_aperm and lm operands) at
// bits 4 and 8, batch <= 64. Bound: megastep_lowbit_opt.cu's plus the fold's
// lm_head bytes.

#include "megastep_grouped.cuh"

// megastep_lowbit_opt.cu's operands with megastep_lowbit_lm.cu's lm ones.
// Returns the cooperative launch's cudaError_t.
extern "C" int ganq_megastep_lowbit_lm_opt(const W8A8Args* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!lm_operands_ok(p) || !(p->qkv_sz || p->ap_q) || lora_any(p) ||
      arch_any(p))
    return (int)cudaErrorInvalidValue;
  if (p->bits == 4) return (int)launch_grouped_b<4, false, true, true>(*p, s);
  if (p->bits == 8) return (int)launch_grouped_b<8, false, true, true>(*p, s);
  return (int)cudaErrorInvalidValue;
}
