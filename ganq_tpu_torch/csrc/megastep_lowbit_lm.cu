// Kernel 14 (megastep_lowbit.cu) with the trailing-unembed fold, for Hopper
// (sm_90a): the instantiations of megastep_grouped.cuh's kernel that, after
// the last layer, run the final norm and int8 rows of the residual and the
// vocab phase (a warp per two int8 lm_head rows, exact int32 dots, logits
// (dv * sx) * scale in float32), in a source of their own so that they
// compile in parallel with the others and the kernels without the fold keep
// their code (compiled into one kernel behind a runtime flag, the fold
// slowed the steps without it by 3%). Packs with zero points or act-order
// and the fold: megastep_lowbit_lm_opt.cu.
//
// Replaces ganq_tpu/ops/megastep_lowbit.py megastep_lowbit_decode (Pallas
// _megastep_lb_kernel with its lm operands: the NV trailing vocab steps)
// at bits 4 and 8, batch <= 64, with or without zero points and act-order.
// Bound of the fold: the V H lm_head bytes (plus its scales, the norm and
// the logits) over 3.35 TB/s, 0.157 ms at Llama-3.1-8B's 128256 x 4096.

#include "megastep_grouped.cuh"

// megastep_lowbit.cu's operands with lm_w8 [V, H] int8, lm_scale [V] and
// lm_norm [H] float32 and logits [B, V] float32 out (V a multiple of 128).
// Returns the cooperative launch's cudaError_t.
extern "C" int ganq_megastep_lowbit_lm(const W8A8Args* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!lm_operands_ok(p) || p->qkv_sz || p->ap_q || lora_any(p) ||
      arch_any(p))
    return (int)cudaErrorInvalidValue;
  if (p->bits == 4) return (int)launch_grouped_b<4, false, false, true>(*p, s);
  if (p->bits == 8) return (int)launch_grouped_b<8, false, false, true>(*p, s);
  return (int)cudaErrorInvalidValue;
}
