"""Batched weighted 1-D k-means for LUT codebook initialization.

The port of ``ganq_tpu/ops/kmeans.py``: every row solved at once with
weighted Lloyd iterations from a weighted-quantile init (the
``codebook_init="kmeans"`` option). The exact solver, the default, is
``ops/kmeans_exact.py``. The codebook init weights are LeanQuant's
``diag(Hinv)^-exp`` (reference ``gptqmodel/quantization/ganq.py:423-438``).
"""

from __future__ import annotations

import torch


def _weighted_quantile_init(x: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """Per-row weighted quantiles as initial centers. x: [m, n], w: [n] -> [m, k]."""
    xs, order = torch.sort(x, dim=1, stable=True)
    cumw = torch.cumsum(w[order], dim=1)
    targets = ((torch.arange(k, dtype=x.dtype, device=x.device) + 0.5) / k
               * cumw[:, -1:])
    idx = torch.searchsorted(cumw, targets).clamp(0, x.shape[1] - 1)
    return torch.take_along_dim(xs, idx, dim=1)


def weighted_kmeans_1d(x: torch.Tensor, w: torch.Tensor, k: int = 16,
                       iters: int = 25, row_chunk: int = 1024) -> torch.Tensor:
    """Weighted Lloyd k-means per row. x: [m, n], w: [n] -> [m, k] float32.

    Rows run in chunks of ``row_chunk`` to bound the [chunk, n, k] distance
    tensor. Empty clusters keep their previous center. Centers come back
    sorted ascending (canonical LUT order)."""
    x = x.to(torch.float32)
    w = w.to(torch.float32)
    out = []
    for xc in torch.split(x, row_chunk):
        c = _weighted_quantile_init(xc, w, k)
        wx = w[None, :] * xc
        for _ in range(iters):
            a = torch.argmin(torch.abs(xc[:, :, None] - c[:, None, :]), dim=2)
            num = torch.zeros_like(c).scatter_add_(1, a, wx)
            den = torch.zeros_like(c).scatter_add_(1, a, w.expand_as(xc))
            c = torch.where(den > 0, num / torch.clamp(den, min=1e-30), c)
        out.append(torch.sort(c, dim=1).values)
    return torch.cat(out)


def leanquant_weights(hinv_diag: torch.Tensor, exp: float = 4.0) -> torch.Tensor:
    """LeanQuant weighting: diag(Hinv)^-exp (reference ganq.py:427-429)."""
    return hinv_diag.to(torch.float32) ** (-exp)


__all__ = ["weighted_kmeans_1d", "leanquant_weights"]
