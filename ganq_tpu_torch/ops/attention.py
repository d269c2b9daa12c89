"""Prefill attention: plain masked softmax attention.

The port of ``reference_attention`` (``ganq_tpu/ops/attention.py``), which
the JAX package runs for prefill on the CPU and below 256 tokens; above
that it calls JAX's bundled TPU flash kernel, which is not a kernel of the
repo. The port keeps the plain version on every device so that prefill's
numerics stay the reference's. Layouts follow the model code: q/k/v are
[batch, seq, heads, head_dim].
"""

from __future__ import annotations

from typing import Optional

import torch


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor], scale: float
                        ) -> torch.Tensor:
    """Masked softmax attention; GQA via head repeat. The scores are taken
    in the inputs' type and widened to float32 for the softmax."""
    hq, hkv = q.shape[2], k.shape[2]
    if hq != hkv:
        k = torch.repeat_interleave(k, hq // hkv, dim=2)
        v = torch.repeat_interleave(v, hq // hkv, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", q, k).float() * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """Causal prefill attention over the fresh k/v (``flash_attention``'s
    plain branch in the JAX package)."""
    s, t = q.shape[1], k.shape[1]
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(t, device=q.device)[None, :]
    return reference_attention(q, k, v, (ki <= qi)[None, None], scale)


__all__ = ["reference_attention", "causal_attention"]
