// Kernel 14 with gemma's operands (the GEMMA instantiation of
// megastep_grouped.cuh's kernel), for Hopper (sm_90a): Gemma 2's and 3's
// sandwich norms, per-layer sliding windows, attention softcap and dual
// rope, in a source of its own so that the kernel-14 sources compile in
// parallel and the kernels without these operands keep their code. Its
// kernels also carry every other optional operand of kernel 14, each run
// where the call sets it: zero points and act-order orders, qwen3-style
// qk-norm rows and the o/gate-up/down biases, the EoRA epilogue and the
// trailing-unembed fold (one source instead of one per combination).
//
// Replaces ganq_tpu/ops/megastep_lowbit.py megastep_lowbit_decode (Pallas
// _megastep_lb_kernel with its with_sand, with_win, softcap and rope_sel
// operands) at bits 4 and 8, batch <= 64. Where the TPU kernel masks every
// key block from key 0 outside a layer's window, the attention unit here
// starts its key walk at the window's first key and reads no key before
// it. Bound: the step's weight bytes, as megastep_lowbit.cu's, plus the
// sandwich norms (2 H floats a layer) and, on the sliding layers, only the
// K/V rows inside the window.

#include "megastep_grouped.cuh"

// megastep_lowbit.cu's operands with any of pa_norm and pm_norm [L, H] with
// sand [B, H] float32, windows and rope_sel [L] int32 (then cos_half and
// sin_half [2, B, cos_ld]) and softcap, and any of the other optional
// operands of kernel 14. Returns the cooperative launch's cudaError_t.
extern "C" int ganq_megastep_lowbit_gemma(const W8A8Args* p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!gemma_any(p) || !gemma_ok(p) || (lora_any(p) && !lora_all(p)) ||
      (p->lm_w8 && !lm_operands_ok(p)))
    return (int)cudaErrorInvalidValue;
  if (p->bits == 4)
    return (int)launch_grouped_b<4, false, true, true, true, true, true>(*p,
                                                                         s);
  if (p->bits == 8)
    return (int)launch_grouped_b<8, false, true, true, true, true, true>(*p,
                                                                         s);
  return (int)cudaErrorInvalidValue;
}
