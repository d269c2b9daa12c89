// Kernel 14 with zero points or act-order, the EoRA epilogue and the
// trailing-unembed fold (megastep_lowbit_lora_opt.cu and
// megastep_lowbit_lm_opt.cu), for Hopper (sm_90a), in a source of its own
// so that it compiles in parallel.
//
// Replaces ganq_tpu/ops/megastep_lowbit.py megastep_lowbit_decode (Pallas
// _megastep_lb_kernel with its with_lora operands, the EoRA epilogue:
// la_q/lb_q, la_o/lb_o, la_g/lb_g, la_d/lb_d, applied in float32 on the
// activations before their int8 rows) at bits 4 and 8,
// batch <= 64. The rank-r A products go into scratch in the phases that
// already end in a grid barrier (the norm rows, the attention output's and
// the activation's int8 passes), the B products into the rows that own the
// outputs (megastep_grouped.cuh), so the epilogue adds no barrier. Bound:
// the kernel's without adapters plus the bf16 factors, 2 L r bytes times
// (Dqkv + 2 H + 2 I) for B and (2 H + q_dim + I) for A (5.8 MB a layer at
// Llama-3.2-3B widths and r = 64), over 3.35 TB/s.

#include "megastep_grouped.cuh"

// megastep_lowbit_lm_opt.cu's operands with megastep_lowbit_lora.cu's EoRA
// ones. Returns the cooperative launch's cudaError_t.
extern "C" int ganq_megastep_lowbit_lora_lm_opt(const W8A8Args* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!lora_all(p) || !lm_operands_ok(p) || !(p->qkv_sz || p->ap_q) ||
      arch_any(p))
    return (int)cudaErrorInvalidValue;
  if (p->bits == 4)
    return (int)launch_grouped_b<4, false, true, true, true>(*p, s);
  if (p->bits == 8)
    return (int)launch_grouped_b<8, false, true, true, true>(*p, s);
  return (int)cudaErrorInvalidValue;
}
