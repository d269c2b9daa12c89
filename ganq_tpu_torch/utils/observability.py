"""Quantization stat table (the port of ``quant_log_table`` from
``ganq_tpu/utils/observability.py``; the reference's per-module table,
``loop_processor.py:133-156``)."""

from __future__ import annotations

from typing import Any, List


def quant_log_table(entries: List[Any]) -> str:
    """Aligned stat table of ModuleQuantLog rows."""
    header = f"{'layer':>5}  {'module':<32} {'method':<6} {'loss':>12} " \
             f"{'damp':>7} {'time':>7}"
    rows = [header, "-" * len(header)]
    for e in entries:
        rows.append(f"{e.layer:>5}  {e.module:<32} {e.method:<6} "
                    f"{e.loss:>12.5f} {e.damp:>7.4f} {e.duration:>6.1f}s")
    return "\n".join(rows)


__all__ = ["quant_log_table"]
