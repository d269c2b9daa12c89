// Kernel 14 (megastep_lowbit.cu) for packs with zero points or act-order,
// for Hopper (sm_90a): the instantiation of megastep_grouped.cuh's kernel
// that reads the float32 zero-point corrections (*_sz) and the act-order
// column orders (ap_*), in a source of its own so that the two sets of
// instantiations compile in parallel and the symmetric kernel carries none
// of this code.
//
// Replaces ganq_tpu/ops/megastep_lowbit.py megastep_lowbit_decode (Pallas
// _megastep_lb_kernel with its with_zp / with_aperm operands) at bits 4
// and 8, batch <= 64. Bound: as megastep_lowbit.cu's, plus the float32
// corrections (twice the bf16 scales' bytes) and the int32 orders.

#include "megastep_grouped.cuh"

// megastep_lowbit.cu's operands, with qkv_sz/o_sz/gu_sz/dn_sz float32 in
// the layouts of the scales and ap_q/ap_g [L, H], ap_o [L, q_dim] int32
// (zero points and act-order come for all four projections or none; at
// least one of them is given). Returns the cooperative launch's
// cudaError_t.
extern "C" int ganq_megastep_lowbit_opt(const W8A8Args* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->kmajor || p->B > 64 || !(p->qkv_sz || p->ap_q) || p->lm_w8 ||
      lora_any(p) || arch_any(p))
    return (int)cudaErrorInvalidValue;
  if (p->bits == 4) return (int)launch_grouped_b<4, false, true>(*p, s);
  if (p->bits == 8) return (int)launch_grouped_b<8, false, true>(*p, s);
  return (int)cudaErrorInvalidValue;
}
